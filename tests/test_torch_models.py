"""The port's dense models against the JAX package: the layer functions,
the parameter specs (no allocation), the init law, and the full forward
(logits and prefill caches) of the four dense smoke configs in f32, with
the reference's parameters carried across as numpy arrays.  The
reference runs on a one-device mesh (its ``shard_activation`` raises
under jax's Explicit mesh axes on a multi-device mesh)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import meshctx
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.convert import transformer_from_numpy
from repro_torch.models import nn, registry, transformer
from repro_torch.models.config import torch_dtype

DENSE = ("qwen1.5-0.5b", "starcoder2-3b", "qwen3-32b", "minitron-4b")
# the transformer's other kinds (moe and llava), rwkv6 and zamba2
PORTED = DENSE + ("dbrx-132b", "phi3.5-moe-42b-a6.6b", "llava-next-mistral-7b",
                  "rwkv6-1.6b", "zamba2-7b", "whisper-small")
QWEN15_PARAMS = 463_987_712


@pytest.fixture
def one_device_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])
    monkeypatch.setattr(meshctx, "_mesh", mesh)
    return mesh


def _rng(seed=0):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- layers
def test_norms_dense_and_mlps_match_reference():
    """f32: the same ops in the same order (atol 1e-5, rtol 1e-6: BLAS
    and XLA sum the products in different orders)."""
    r = _rng(1)
    x = r.standard_normal((2, 5, 32), dtype=np.float32)
    w = r.standard_normal((32,), dtype=np.float32)
    b = r.standard_normal((32,), dtype=np.float32)
    w1 = r.standard_normal((32, 48), dtype=np.float32) * 0.2
    w2 = r.standard_normal((32, 48), dtype=np.float32) * 0.2
    b1 = r.standard_normal((48,), dtype=np.float32)
    w3 = r.standard_normal((48, 32), dtype=np.float32) * 0.2
    t = torch.from_numpy
    j = jnp.asarray
    cases = [
        (nn.rms_norm(t(x), t(w)), jnn.rms_norm(j(x), j(w))),
        (nn.layer_norm(t(x), t(w), t(b)), jnn.layer_norm(j(x), j(w), j(b))),
        (nn.dense(t(x), t(w1), t(b1)), jnn.dense(j(x), j(w1), j(b1))),
        (nn.swiglu(t(x), t(w1), t(w2), t(w3)),
         jnn.swiglu(j(x), j(w1), j(w2), j(w3))),
        (nn.gelu_mlp(t(x), t(w1), t(b1), t(w3), t(b)),
         jnn.gelu_mlp(j(x), j(w1), j(b1), j(w3), j(b))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-6)


def test_norms_in_bf16_keep_the_reference_cast_order():
    """bf16: normalise in f32, cast, then multiply by the cast weight —
    within one bf16 rounding of the reference."""
    r = _rng(2)
    x = r.standard_normal((3, 64), dtype=np.float32)
    w = r.standard_normal((64,), dtype=np.float32)
    got = nn.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    want = jnn.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    """Tables, position-direct angles and the rotation (f32; cos / sin of
    the same f32 angles, 1e-6 for the two libraries' sin / cos)."""
    hd, T = 16, 11
    cos, sin = nn.rope_freqs(hd, T, theta)
    jcos, jsin = jnn.rope_freqs(hd, T, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    pos = np.array([[0], [3], [10]], np.int32)
    c_at, s_at = nn.rope_at(hd, torch.from_numpy(pos), theta)
    # rope_at is bitwise the table at the same positions
    np.testing.assert_array_equal(c_at.numpy(), cos.numpy()[pos])
    np.testing.assert_array_equal(s_at.numpy(), sin.numpy()[pos])
    x = _rng(3).standard_normal((2, T, 3, hd), dtype=np.float32)
    got = nn.apply_rope(torch.from_numpy(x), cos, sin)
    want = jnn.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    xd = x[:, :1]
    got = nn.apply_rope_direct(torch.from_numpy(xd), c_at[:2], s_at[:2])
    want = jnn.apply_rope_direct(jnp.asarray(xd), jnp.asarray(c_at[:2]),
                                 jnp.asarray(s_at[:2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -------------------------------------------------------------- specs
def _shapes(tree, is_leaf):
    if is_leaf(tree):
        return tuple(tree.shape), tree.init, tuple(tree.axes)
    return {k: _shapes(v, is_leaf) for k, v in tree.items()}


@pytest.mark.parametrize("arch", PORTED)
def test_param_specs_equal_reference(arch):
    """Full configs: the same tree of shapes, init laws and logical axes
    as the reference's, with nothing allocated."""
    cfg = configs.get_config(arch)
    got = _shapes(registry.param_specs(cfg), nn.is_spec)
    want = _shapes(jregistry.param_specs(jconfigs.get_config(arch)),
                   jnn.is_spec)
    assert got == want


def test_qwen15_parameter_count():
    cfg = configs.get_config("qwen1.5-0.5b")
    assert nn.spec_numel(registry.param_specs(cfg)) == QWEN15_PARAMS
    assert cfg.param_count() == jconfigs.get_config(
        "qwen1.5-0.5b").param_count()


def test_configs_copy_the_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    for arch in PORTED:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke_config,
                           jconfigs.get_smoke_config)):
            a, b = get(arch), jget(arch)
            assert a.__dict__ == b.__dict__
            assert (a.hd, a.padded_vocab) == (b.hd, b.padded_vocab)
    assert torch_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError):
        torch_dtype("int4")


def test_every_arch_is_ported_and_unknown_ones_raise():
    """Every architecture id of the reference has its config in the port;
    an unknown id or kind raises, as in the reference."""
    assert sorted(PORTED) == sorted(jconfigs.ARCHS)
    with pytest.raises(KeyError):
        configs.get_config("whisper-large")
    cfg = configs.get_smoke_config("qwen1.5-0.5b").scaled(kind="encoder")
    with pytest.raises(ValueError, match="encoder"):
        registry.param_specs(cfg)


def test_init_law_and_seed():
    """normal leaves have std scale/sqrt(fan_in), embeddings 0.02, bias
    zeros, norms ones; one seed gives one set of weights."""
    cfg = configs.get_smoke_config("qwen1.5-0.5b").scaled(d_model=128,
                                                          d_ff=256)
    specs = registry.param_specs(cfg)

    def make(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return nn.init_params(specs, g, "cpu")

    p = make(0)
    assert float(p["embed"].std()) == pytest.approx(0.02, rel=0.05)
    wq = p["layers"]["attn"]["wq"]
    assert float(wq.std()) == pytest.approx(1 / math.sqrt(128), rel=0.05)
    assert bool((p["layers"]["attn"]["bq"] == 0).all())
    assert bool((p["final_w"] == 1).all())
    assert torch.equal(make(0)["embed"], p["embed"])
    assert not torch.equal(make(1)["embed"], p["embed"])


def test_entry_points_default_to_cuda():
    cfg = configs.get_smoke_config("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        nn.init_params(registry.param_specs(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.init_decode_state(cfg, 2, 8)


def test_decode_state_specs_allocate_nothing():
    cfg = configs.get_config("qwen1.5-0.5b")
    specs = registry.decode_state_specs(cfg, 8, 2112)
    assert set(specs) == {"k", "v"}
    for s in specs.values():
        assert s.device.type == "meta" and s.dtype == torch.bfloat16
        assert tuple(s.shape) == (24, 8, 2112, 16, 64)


# ------------------------------------------------------------ forward
def _models(arch, seed=0):
    cfg_j = jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32")
    cfg = configs.get_smoke_config(arch).scaled(compute_dtype="float32")
    params = jnn.init_params(jregistry.param_specs(cfg_j),
                             jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return cfg_j, params, cfg, transformer_from_numpy(cfg, tree, "cpu")


def test_transformer_holds_the_reference_names():
    cfg_j, params, cfg, model = _models("starcoder2-3b")
    names = set(dict(model.named_parameters()))
    layer0 = {n.split(".", 2)[2] for n in names if n.startswith("layers.0.")}
    want = {f"attn.{k}" for k in params["layers"]["attn"]}
    want |= {f"mlp.{k}" for k in params["layers"]["mlp"]}
    want |= {k for k in params["layers"] if k not in ("attn", "mlp")}
    assert layer0 == want
    assert {n for n in names if not n.startswith("layers.")} == {
        k for k in params if k != "layers"}
    np.testing.assert_array_equal(
        model.layers[1].attn["wq"].numpy(),
        np.asarray(params["layers"]["attn"]["wq"][1]))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, one_device_mesh):
    """Logits and prefill caches of the smoke config in f32 against
    ``repro.models.transformer.forward`` (pure-JAX chunked attention).
    Measured max |diff|: logits 3e-7 to 2.1e-6 (magnitudes up to 3.9),
    caches 1.4e-6 to 2.1e-6, from the summation order of the matmuls and
    the attention; bar 1e-5."""
    cfg_j, params, cfg, model = _models(arch)
    tokens = _rng(4).integers(0, cfg.vocab, size=(2, 13), dtype=np.int32)
    lj, (kj, vj) = jtransformer.forward(cfg_j, params, jnp.asarray(tokens))
    lt, (kt, vt) = transformer.forward(cfg, model, torch.from_numpy(tokens))
    assert lt.shape == lj.shape and kt.shape == kj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5,
                               rtol=0)
    last, _ = registry.prefill_fn(cfg)(model,
                                       {"tokens": torch.from_numpy(tokens)})
    jlast, _ = jregistry.prefill_fn(cfg_j)(params,
                                           {"tokens": jnp.asarray(tokens)})
    assert last.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-5,
                               rtol=0)


def test_serve_fn_matches_reference(one_device_mesh):
    """One decode step against a prefill cache (growing-cache layout),
    f32, against ``registry.serve_fn``."""
    cfg_j, params, cfg, model = _models("qwen3-32b")
    tokens = _rng(5).integers(0, cfg.vocab, size=(2, 7), dtype=np.int32)
    nxt = _rng(6).integers(0, cfg.vocab, size=(2, 1), dtype=np.int32)
    _, (kj, vj) = jtransformer.forward(cfg_j, params, jnp.asarray(tokens))
    lj, (nkj, _) = jregistry.serve_fn(cfg_j)(
        params, {"tokens": jnp.asarray(nxt)}, {"k": kj, "v": vj})
    _, (kt, vt) = transformer.forward(cfg, model, torch.from_numpy(tokens))
    lt, (nkt, _) = registry.serve_fn(cfg)(
        model, {"tokens": torch.from_numpy(nxt)}, {"k": kt, "v": vt})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(nkt.numpy(), np.asarray(nkj), atol=1e-5,
                               rtol=0)


def test_bf16_head_dim_128_matches_reference(one_device_mesh):
    """The model path in the dtype it serves in, at the head dim of three
    of the four dense configs: qwen3-32b's smoke depth and widths with
    head_dim 128, bf16, against the jitted JAX model.  Layer 0's prefill
    caches are within 2^-8 max|reference| (equal, or a few values one
    bf16 rounding apart: the CPU bf16 matmul's kernel varies between
    processes; measured up to 8.1e-4 max|reference|);
    deeper values differ by bf16 roundings that accumulate through the
    layers (the bf16 attention's P and the residual stream), so the
    logits, the caches and one decode step on the reference's cache are
    held within 2^-4 max|reference| and to a relative RMS difference of
    2^-5 (measured over 15 processes, varying between them as layer 0
    does: max 0.0064-0.0198 max|reference|, RMS 0.0045-0.0119)."""
    cfg_j = jconfigs.get_smoke_config("qwen3-32b").scaled(head_dim=128)
    cfg = configs.get_smoke_config("qwen3-32b").scaled(head_dim=128)
    assert cfg.compute_dtype == "bfloat16" and cfg.hd == 128
    params = jnn.init_params(jregistry.param_specs(cfg_j),
                             jax.random.PRNGKey(0))
    model = transformer_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   "cpu")
    tokens = _rng(5).integers(0, cfg.vocab, size=(2, 24), dtype=np.int32)
    nxt = _rng(6).integers(0, cfg.vocab, size=(2, 1), dtype=np.int32)
    lj, (kj, vj) = jax.jit(lambda p, t: jtransformer.forward(cfg_j, p, t))(
        params, jnp.asarray(tokens))
    lt, (kt, vt) = transformer.forward(cfg, model, torch.from_numpy(tokens))

    def f32(x):
        return np.array(x.astype(jnp.float32))

    for got, want in ((kt[0], kj[0]), (vt[0], vj[0])):
        want = f32(want)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2.0 ** -8 * np.abs(want).max())
    sj, _ = jax.jit(lambda p, t, c: jregistry.serve_fn(cfg_j)(
        p, {"tokens": t}, c))(params, jnp.asarray(nxt), {"k": kj, "v": vj})
    cache = {"k": torch.from_numpy(f32(kj)).bfloat16(),
             "v": torch.from_numpy(f32(vj)).bfloat16()}
    st, _ = registry.serve_fn(cfg)(model, {"tokens": torch.from_numpy(nxt)},
                                   cache)
    for got, want in ((lt, lj), (kt, kj), (vt, vj), (st, sj)):
        want = f32(want)
        diff = got.float().numpy() - want
        assert np.abs(diff).max() <= 2.0 ** -4 * np.abs(want).max()
        assert np.linalg.norm(diff) <= 2.0 ** -5 * np.linalg.norm(want)
