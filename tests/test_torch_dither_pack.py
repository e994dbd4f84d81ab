"""The port's signed quantize-and-pack codec (``kernels.ops.dither_pack_*``,
the plain version on the CPU) against the JAX package's Pallas kernel
(interpret mode) and its jnp oracle, at tests/test_kernels.py:12-13's
bits and shapes: packed words bitwise, decoded values within 1e-6, and
the error still exactly uniform.  The CUDA kernels are held to the plain
version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dither_pack, ops, ref

W = 0.05
SHAPES = [(128,), (1000, 37), (3, 5, 7, 11)]


def _inputs(bits, shape):
    rng = np.random.default_rng(bits + len(shape))
    x = (rng.normal(0, 0.1, shape)).astype(np.float32)
    s = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return x, s


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_words_and_decode_match(bits, shape):
    x, s = _inputs(bits, shape)
    w_ref, n_ref = jops.dither_pack_encode(jnp.asarray(x), jnp.asarray(s), W,
                                           bits=bits)
    w, n = ops.dither_pack_encode(torch.from_numpy(x), torch.from_numpy(s),
                                  W, bits=bits)
    assert n == n_ref == x.size and w.dtype == torch.int32
    assert np.array_equal(w.numpy(), np.asarray(w_ref))
    # the jnp oracle of the same words
    g = 32 // bits
    oracle = jref.dither_pack_ref(jops._pad_rows(jnp.asarray(x), g),
                                  jops._pad_rows(jnp.asarray(s), g), W, bits)
    assert np.array_equal(w.numpy(), np.asarray(oracle))
    y_ref = jops.dither_unpack_decode(w_ref, jnp.asarray(s), W, bits, shape)
    y = ops.dither_unpack_decode(w, torch.from_numpy(s), W, bits, shape)
    assert tuple(y.shape) == shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_signed_pack_roundtrip(bits):
    """pack_ref / unpack_ref sign-extend every value of the signed range,
    as the reference's."""
    g = 32 // bits
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    m = rng.integers(lo, hi + 1, (3, g, 128)).astype(np.int32)
    m[0, :, 0] = lo
    m[0, :, 1] = hi
    words = ref.pack_ref(torch.from_numpy(m), bits)
    assert np.array_equal(words.numpy(),
                          np.asarray(jref.pack_ref(jnp.asarray(m), bits)))
    assert np.array_equal(ref.unpack_ref(words, bits).numpy(), m)


@pytest.mark.parametrize("bits", [8, 16])
def test_error_is_uniform(bits):
    """As tests/test_kernels.py:28: the pipeline is still an exact AINQ
    quantizer."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(0, 0.3, 20000)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(-0.5, 0.5, 20000).astype(np.float32))
    packed, _ = ops.dither_pack_encode(x, s, W, bits=bits)
    err = (ops.dither_unpack_decode(packed, s, W, bits, x.shape) - x).numpy()
    assert abs(err.std() - W / np.sqrt(12)) < W * 0.02
    assert np.abs(err).max() <= W / 2 + 1e-6


def test_clamps_to_the_signed_range():
    x = torch.tensor([100.0, -100.0, 0.0] * 100)
    s = torch.zeros_like(x)
    w, _ = ops.dither_pack_encode(x, s, W, bits=4)
    m = ref.unpack_ref(w, 4).reshape(-1)[: x.numel()]
    assert m[:3].tolist() == [7, -8, 0]


def test_bad_arguments_raise():
    x = torch.zeros(300)
    with pytest.raises(ValueError):
        ops.dither_pack_encode(x, x, W, bits=5)
    with pytest.raises(ValueError):
        ops.dither_pack_encode(x, torch.zeros(299), W, bits=8)
    with pytest.raises(ValueError):  # 300 coords at b = 8 need one row
        ops.dither_unpack_decode(torch.zeros((2, 128), dtype=torch.int32), x,
                                 W, 8, x.shape)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 4, 128))
    with pytest.raises(ValueError):
        dither_pack.dither_pack(x, x, W, 8)
    with pytest.raises(ValueError):
        dither_pack.unpack_decode(torch.zeros((1, 128), dtype=torch.int32), x,
                                  W, 8)
    assert dither_pack.LAUNCHES == {"dither_pack": 0, "unpack_decode": 0}


def test_interpret_kernel_equals_oracle_at_a_tie_prone_width():
    """w = 1/7: the reference kernel multiplies by f32(1.0 / w) (from
    f64), the oracle divides by the constant (f32(1 / f32(w))); the port
    follows the kernel."""
    x, s = _inputs(8, (1000, 37))
    w = 1.0 / 7.0
    w_ref, _ = jops.dither_pack_encode(jnp.asarray(x), jnp.asarray(s), w,
                                       bits=8)
    got, _ = ops.dither_pack_encode(torch.from_numpy(x), torch.from_numpy(s),
                                    w, bits=8)
    assert np.array_equal(got.numpy(), np.asarray(w_ref))
