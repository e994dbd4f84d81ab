"""The port's synthetic data and ``prng.randint`` against the JAX
package: tokens bitwise equal for several (seed, step, client) triples
at vocab 256 and 151936 (qwen1.5-0.5b's), seq 32, both generators; the
integer draw bitwise equal to ``jax.random.randint`` on 2^16 draws for
spans that are odd, past 2^16 (where jax's multiplier wraps to 0) and
the full int32 range."""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.core import prng
from repro_torch.data import synthetic as tsyn
from repro_torch.models.config import ModelConfig

TRIPLES = [(0, 0, None), (3, 5, 2), (11, 17, 7), (5, 1, 0)]


@pytest.mark.parametrize("vocab", [256, 151936])
@pytest.mark.parametrize("kind", ["lm", "uniform"])
def test_tokens_bitwise(vocab, kind):
    for seed, step, client in TRIPLES:
        jc = jsyn.DataConfig(vocab=vocab, seq_len=32, global_batch=4,
                             seed=seed, kind=kind)
        tc = tsyn.DataConfig(vocab=vocab, seq_len=32, global_batch=4,
                             seed=seed, kind=kind)
        want = np.asarray(jsyn.batch_fn(jc)(jc, step, client)["tokens"])
        got = tsyn.batch_fn(tc)(tc, step, client, device="cpu")["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 151936), (-5, 1000003),
                                   (3, 65537), (7, 12345), (0, 3),
                                   (-2 ** 31, 2 ** 31 - 1), (5, 5), (9, 2)])
def test_randint_bitwise(lo, hi):
    for seed in (0, 42):
        want = np.asarray(jax.jit(lambda k: jax.random.randint(
            k, (1 << 16,), lo, hi))(jax.random.PRNGKey(seed)))
        got = prng.randint(prng.PRNGKey(seed), (1 << 16,), lo, hi,
                           device="cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_frontend_stubs():
    """The dense and moe kinds' batch passes through; llava gets its
    patch stub (bitwise the reference's: tests/test_torch_llava.py);
    whisper gets its frames stub, bitwise the reference's."""
    cfg = ModelConfig(name="x", kind="dense", n_layers=1, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab=16, n_patches=3)
    batch = {"tokens": torch.zeros((2, 5), dtype=torch.int32)}
    for kind in ("dense", "moe"):
        assert tsyn.with_frontend_stubs(batch, cfg.scaled(kind=kind)) is batch
    out = tsyn.with_frontend_stubs(batch, cfg.scaled(kind="llava"))
    assert out["tokens"] is batch["tokens"] and "patches" not in batch
    assert out["patches"].shape == (2, 3, 8)
    wcfg = cfg.scaled(kind="whisper", encoder_len=6)
    out = tsyn.with_frontend_stubs(batch, wcfg)
    assert out["tokens"] is batch["tokens"] and "frames" not in batch
    want = jsyn.with_frontend_stubs({"tokens": jax.numpy.zeros((2, 5))},
                                    wcfg)["frames"]
    assert out["frames"].shape == (2, 6, 8)
    np.testing.assert_array_equal(out["frames"].numpy(), np.asarray(want))
