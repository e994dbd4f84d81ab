"""The port's llava kind against the JAX package's: the patch stub
(``data.synthetic.with_frontend_stubs``) bitwise, the forward with its
patch projection (the text positions' logits, the loss, the prefill's
last logits and its caches over patches and text), one decode step after
the prefill, the naive generation loop token for token, and bf16 by its
error against the f32 model.  llava's smoke config (4 patches) in f32 on
the CPU; the reference runs jitted on a one-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsyn
from repro.dist import meshctx
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro.serve import naive_generate as j_naive_generate
from repro_torch import configs
from repro_torch.convert import transformer_from_numpy
from repro_torch.core import prng
from repro_torch.data import synthetic as tsyn
from repro_torch.models import registry, transformer
from repro_torch.serve import naive_generate

ARCH = "llava-next-mistral-7b"


@pytest.fixture
def one_device_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])
    monkeypatch.setattr(meshctx, "_mesh", mesh)
    return mesh


def _models(dtype="float32", seed=0):
    cfg_j = jconfigs.get_smoke_config(ARCH).scaled(compute_dtype=dtype)
    cfg = configs.get_smoke_config(ARCH).scaled(compute_dtype=dtype)
    params = jnn.init_params(jregistry.param_specs(cfg_j),
                             jax.random.PRNGKey(seed))
    model = transformer_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   "cpu")
    return cfg_j, params, cfg, model


def _batches(cfg_j, cfg, B, T, seed=4):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, T),
                                                  dtype=np.int32)
    return (jsyn.with_frontend_stubs({"tokens": jnp.asarray(tokens)}, cfg_j),
            tsyn.with_frontend_stubs({"tokens": torch.from_numpy(tokens)},
                                     cfg))


@pytest.mark.parametrize("key", [None, 3, 77])
def test_patch_stub_bitwise(key):
    """``0.02 * normal(key, (B, n_patches, d_model))`` with the default
    key PRNGKey(13): bit for bit the reference's, at the smoke and the
    full config's widths (576 patches of 4096)."""
    for get, jget in ((configs.get_smoke_config, jconfigs.get_smoke_config),
                      (configs.get_config, jconfigs.get_config)):
        cfg, cfg_j = get(ARCH), jget(ARCH)
        B = 2 if cfg.d_model < 1024 else 1
        tokens = np.zeros((B, 3), np.int32)
        jk = None if key is None else jax.random.PRNGKey(key)
        tk = None if key is None else prng.PRNGKey(key)
        want = np.asarray(jsyn.with_frontend_stubs(
            {"tokens": jnp.asarray(tokens)}, cfg_j, jk)["patches"])
        got = tsyn.with_frontend_stubs({"tokens": torch.from_numpy(tokens)},
                                       cfg, tk)["patches"]
        assert got.dtype == torch.float32
        assert got.shape == (B, cfg.n_patches, cfg.d_model)
        np.testing.assert_array_equal(got.numpy(), want)


def test_specs_and_names():
    """``patch_proj`` (d_model, d_model) joins the dense tree, as a
    parameter of the port's model."""
    cfg_j, params, cfg, model = _models()
    specs = registry.param_specs(cfg)
    assert specs["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    names = dict(model.named_parameters())
    np.testing.assert_array_equal(names["patch_proj"].numpy(),
                                  np.asarray(params["patch_proj"]))
    assert "layers.0.mlp.w_gate" in names


def test_forward_matches_reference(one_device_mesh):
    """Text-position logits (logits_fn), the loss, and the prefill's last
    logits and its caches over 4 patches + 13 tokens in f32, within the
    dense tests' 1e-5 (loss 1e-6 relative) of the jitted reference."""
    cfg_j, params, cfg, model = _models()
    jb, tb = _batches(cfg_j, cfg, 2, 13)
    lj = np.asarray(jax.jit(lambda p, b: jregistry.logits_fn(cfg_j, p, b))(
        params, jb))
    with torch.no_grad():
        lt = registry.logits_fn(cfg, model, tb)
    assert lt.shape == lj.shape == (2, 13, cfg.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), lj, atol=1e-5, rtol=0)
    loss_j = float(jax.jit(jregistry.loss_fn(cfg_j))(params, jb))
    loss_t = float(registry.loss_fn(cfg)(model, tb))
    assert loss_t == pytest.approx(loss_j, rel=1e-6)
    lastj, (kj, vj) = jax.jit(jregistry.prefill_fn(cfg_j))(params, jb)
    with torch.no_grad():
        last, (kt, vt) = registry.prefill_fn(cfg)(model, tb)
    assert kt.shape == (cfg.n_layers, 2, cfg.n_patches + 13, cfg.n_kv_heads,
                        cfg.hd)
    for got, want in ((last, lastj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    # without patches the text runs alone (the reference's forward too)
    with torch.no_grad():
        alone, _ = transformer.forward(cfg, model, tb["tokens"])
    ja, _ = jax.jit(lambda p, t: jregistry.transformer.forward(cfg_j, p, t))(
        params, jb["tokens"])
    np.testing.assert_allclose(alone.numpy(), np.asarray(ja), atol=1e-5,
                               rtol=0)


def test_decode_after_prefill_matches_reference(one_device_mesh):
    """One decode step on the prefill's cache (patches + text), whose
    position continues after both, against ``registry.serve_fn``."""
    cfg_j, params, cfg, model = _models()
    jb, tb = _batches(cfg_j, cfg, 2, 7, seed=5)
    nxt = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 1),
                                            dtype=np.int32)
    _, (kj, vj) = jax.jit(jregistry.prefill_fn(cfg_j))(params, jb)
    lj, (nkj, _) = jax.jit(jregistry.serve_fn(cfg_j))(
        params, {"tokens": jnp.asarray(nxt)}, {"k": kj, "v": vj})
    with torch.no_grad():
        _, (kt, vt) = registry.prefill_fn(cfg)(model, tb)
        lt, (nkt, _) = registry.serve_fn(cfg)(
            model, {"tokens": torch.from_numpy(nxt)}, {"k": kt, "v": vt})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(nkt.numpy(), np.asarray(nkj), atol=1e-5,
                               rtol=0)


def test_naive_generate_matches_reference(one_device_mesh):
    """The naive loop (prefill over patches + prompt, then lockstep
    decode) token for token against the reference's."""
    cfg_j, params, cfg, model = _models()
    jb, tb = _batches(cfg_j, cfg, 2, 6, seed=1)
    want = np.asarray(j_naive_generate(cfg_j, params, jb, 8))
    got = naive_generate(cfg, model, tb, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_error_within_twice_the_reference(one_device_mesh):
    """llava in bf16 at head_dim 32: the text logits' error against the
    f32 model at most twice the JAX bf16 model's own (relative L2)."""
    _, params, _, _ = _models()
    cfg_j = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    assert cfg.compute_dtype == "bfloat16"
    model = transformer_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   "cpu")
    jb, tb = _batches(cfg_j, cfg, 2, 24, seed=8)
    l32 = np.asarray(jax.jit(lambda p, b: jregistry.logits_fn(
        cfg_j.scaled(compute_dtype="float32"), p, b))(params, jb))
    ljb = np.asarray(jax.jit(lambda p, b: jregistry.logits_fn(cfg_j, p, b))(
        params, jb).astype(jnp.float32))
    with torch.no_grad():
        ltb = registry.logits_fn(cfg, model, tb).float().numpy()
    ej, et = np.linalg.norm(ljb - l32), np.linalg.norm(ltb - l32)
    assert 0 < et <= 2 * ej, (et, ej)
