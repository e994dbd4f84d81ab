"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``): capacity, routing (experts, positions
within an expert, the keep mask) bitwise, ties broken toward the lower
expert, dropped choices, the f32 output and gradients, and the bf16
combine bitwise; and the moe kind's whole model (logits, loss, one decode
step) against ``repro.models.registry``.  phi3.5-moe's smoke config (top
2 of 4 experts), dbrx's scaled to top 4 (its published k), and one at
capacity factor 0.5, where choices are certainly dropped.  The reference
runs jitted on a one-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import meshctx
from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.convert import transformer_from_numpy
from repro_torch.models import moe, registry

# (arch, overrides): the smoke configs the tests scale
CASES = {
    "phi35": ("phi3.5-moe-42b-a6.6b", {}),
    "dbrx_top4": ("dbrx-132b", {"top_k": 4}),
    "drops": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}),
}


@pytest.fixture
def one_device_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])
    monkeypatch.setattr(meshctx, "_mesh", mesh)
    return mesh


def _cfgs(case, dtype="float32"):
    arch, kw = CASES[case]
    kw = dict(kw, compute_dtype=dtype)
    return (jconfigs.get_smoke_config(arch).scaled(**kw),
            configs.get_smoke_config(arch).scaled(**kw))


def _weights(cfg, seed=0):
    """Seeded numpy weights of one layer's moe subtree (f32)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": rng.normal(size=(d, e)).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
            "w_up": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
            "w_down": (rng.normal(size=(e, f, d)) / 10).astype(np.float32)}


def _x(cfg, B, T, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)


def _jroute(cfg, tokens, router):
    """The reference block's routing, its lines (``repro/models/moe.py``
    :52-63) jitted: (top_w, top_e, flat_pos, keep)."""
    E, K = cfg.n_experts, cfg.top_k
    C = jmoe.capacity(tokens.shape[0], cfg)

    def f(tokens, router):
        gates = jax.nn.softmax(jnp.einsum(
            "nd,de->ne", tokens.astype(jnp.float32),
            router.astype(jnp.float32)))
        top_w, top_e = jax.lax.top_k(gates, K)
        top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
        flat_e = top_e.reshape(-1)
        onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=0) - onehot
        flat_pos = jnp.sum(pos * onehot, axis=-1)
        return top_w, top_e, flat_pos, flat_pos < C

    return [np.array(a) for a in jax.jit(f)(tokens, router)]


def _jblock(cfg, w, x):
    return jax.jit(lambda w, x: jmoe.moe_block(cfg, {"moe": w}, x))(w, x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_capacity_matches_reference(case):
    cfg_j, cfg = _cfgs(case)
    for n in list(range(1, 300)) + [1024, 2048, 4095, 4096, 8192, 16384]:
        assert moe.capacity(n, cfg) == jmoe.capacity(n, cfg_j), n
    full = configs.get_config("phi3.5-moe-42b-a6.6b")
    assert moe.capacity(4096, full) == 640  # the train microbatch, 2 x 2048
    assert moe.capacity(8, full) == 8       # an 8-slot decode step
    assert moe.capacity(8, configs.get_config("dbrx-132b")) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_bitwise(case, dtype):
    """Experts, positions within an expert and the keep mask equal the
    reference's bit for bit on 3 x 40 seeded tokens (f32, or rounded to
    bf16 as the bf16 model routes them); the renormalized weights, which
    lie in [0, 1], within 1e-6 (the router product's and exp's last bits
    differ: the port's product is f64 rounded once)."""
    cfg_j, cfg = _cfgs(case)
    w = _weights(cfg)
    tok = _x(cfg, 3, 40).reshape(-1, cfg.d_model)
    tt = torch.from_numpy(tok).to(getattr(torch, dtype))
    jt = jnp.asarray(tok).astype(getattr(jnp, dtype))
    want = _jroute(cfg_j, jt, jnp.asarray(w["router"]))
    top_w, top_e, pos, keep, C = moe.route(cfg, tt,
                                           torch.from_numpy(w["router"]))
    assert C == jmoe.capacity(tok.shape[0], cfg_j)
    np.testing.assert_array_equal(top_e.numpy(), want[1])
    np.testing.assert_array_equal(pos.numpy(), want[2])
    np.testing.assert_array_equal(keep.numpy(), want[3])
    np.testing.assert_allclose(top_w.numpy(), want[0], rtol=0, atol=1e-6)
    if case == "drops":
        assert not keep.all()
    else:
        assert keep.all()


def test_ties_go_to_the_lower_expert():
    """Exact ties (a router whose columns repeat) are broken toward the
    lower expert index, as ``jax.lax.top_k`` breaks them."""
    cfg_j, cfg = _cfgs("dbrx_top4")
    w = _weights(cfg)["router"]
    router = np.repeat(w[:, :2], 2, axis=1)  # columns 0 = 1, 2 = 3
    tok = _x(cfg, 1, 64).reshape(-1, cfg.d_model)
    want = _jroute(cfg_j, jnp.asarray(tok), jnp.asarray(router))
    _, top_e, pos, keep, _ = moe.route(cfg, torch.from_numpy(tok),
                                       torch.from_numpy(router))
    np.testing.assert_array_equal(top_e.numpy(), want[1])
    np.testing.assert_array_equal(pos.numpy(), want[2])
    assert (np.diff(top_e.numpy()[:, :2], axis=1) == 1).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_f32_matches_reference(case, one_device_mesh, monkeypatch):
    """The block's f32 output within 1e-5 max|y| of the jitted reference;
    in the drops case the dropped-choice count (read by wrapping
    ``moe.route``) is the reference routing's."""
    cfg_j, cfg = _cfgs(case)
    w, x = _weights(cfg), _x(cfg, 2, 24)
    want = np.asarray(_jblock(cfg_j, {k: jnp.asarray(v) for k, v in
                                      w.items()}, jnp.asarray(x)))
    drops, route = [], moe.route

    def counted(*args):
        out = route(*args)
        drops.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(moe, "route", counted)
    got = moe.moe_block(cfg, {k: torch.from_numpy(v) for k, v in
                              w.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    keep = _jroute(cfg_j, jnp.asarray(x.reshape(-1, cfg.d_model)),
                   jnp.asarray(w["router"]))[3]
    assert drops == [int((~keep).sum())]
    assert (drops[0] > 0) == (case == "drops")


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_f32_gradients_match_reference(case, one_device_mesh):
    """Gradients of <block(x), c> for x, the router and the three expert
    weights within 1e-4 max|g| of ``jax.grad`` of the jitted reference;
    a dropped choice gets none (its expert rows see only kept tokens)."""
    cfg_j, cfg = _cfgs(case)
    w, x = _weights(cfg), _x(cfg, 2, 24)
    c = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    names = ("router", "w_gate", "w_up", "w_down")

    def jloss(x, *ws):
        y = jmoe.moe_block(cfg_j, {"moe": dict(zip(names, ws))}, x)
        return jnp.sum(y * jnp.asarray(c))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in names))
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w[k]).requires_grad_() for k in names]
    y = moe.local_moe(cfg, xt, *wt)
    got = torch.autograd.grad((y * torch.from_numpy(c)).sum(), [xt] + wt)
    for g, wg in zip(got, want):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max())
    assert np.abs(np.asarray(want[1])).max() > 0


@pytest.mark.parametrize("case", ["phi35", "dbrx_top4"])
def test_bf16_combine_bitwise(case, one_device_mesh):
    """The bf16 combine.  The jitted reference block's output equals, bit
    for bit, the sum of its K weighted expert outputs in choice order with
    a bf16 rounding after each add (its expert outputs recomputed by its
    own jitted lines), and not the f32 sum rounded once (which differs
    at K = 4); the port's
    ``moe.combine`` on the same expert outputs and routing gives the same
    bits."""
    cfg_j, cfg = _cfgs(case, "bfloat16")
    E, K = cfg.n_experts, cfg.top_k
    w = {k: jnp.asarray(v) for k, v in _weights(cfg).items()}
    x = jnp.asarray(_x(cfg, 2, 32)).astype(jnp.bfloat16)
    y = np.asarray(_jblock(cfg_j, w, x).astype(jnp.float32))
    tokens = x.reshape(-1, cfg.d_model)
    N = tokens.shape[0]
    C = jmoe.capacity(N, cfg_j)
    top_w, top_e, flat_pos, keep = _jroute(cfg_j, tokens, w["router"])

    def expert_out(tokens, w_gate, w_up, w_down, e, p, keep):
        # the reference's dispatch and expert FFN (moe.py:65-73)
        tok_idx = jnp.repeat(jnp.arange(N), K)
        buf = jnp.zeros((E, C, cfg.d_model), tokens.dtype)
        buf = buf.at[jnp.where(keep, e, 0), jnp.where(keep, p, 0)].add(
            jnp.where(keep[:, None], tokens[tok_idx], 0.0))
        h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", buf,
                                   w_gate.astype(tokens.dtype))) * \
            jnp.einsum("ecd,edf->ecf", buf, w_up.astype(tokens.dtype))
        return jnp.einsum("ecf,efd->ecd", h, w_down.astype(tokens.dtype))

    out = jax.jit(expert_out)(tokens, w["w_gate"], w["w_up"], w["w_down"],
                              jnp.asarray(top_e.reshape(-1)),
                              jnp.asarray(flat_pos), jnp.asarray(keep))
    out = torch.from_numpy(np.asarray(out.astype(jnp.float32))).bfloat16()
    slot = np.where(keep, top_e.reshape(-1) * C + flat_pos, E * C)
    gathered = torch.cat([out.reshape(E * C, -1),
                          torch.zeros(1, cfg.d_model, dtype=torch.bfloat16)])
    parts = (gathered[torch.from_numpy(slot)]
             * torch.from_numpy(top_w.reshape(-1, 1)).bfloat16()).view(
                 N, K, -1)
    seq = parts[:, 0]
    for j in range(1, K):
        seq = seq + parts[:, j]
    once = parts.float().sum(1).bfloat16()
    np.testing.assert_array_equal(seq.float().numpy(),
                                  y.reshape(N, -1))
    # with K = 2 both orders round once (0 + a is exact)
    assert (once != seq).any() == (K > 2)
    got = moe.combine(out.reshape(E * C, -1), torch.from_numpy(slot),
                      torch.from_numpy(top_w))
    np.testing.assert_array_equal(got.float().numpy(), y.reshape(N, -1))


# ------------------------------------------------------------ the model
def _models(arch, dtype="float32", seed=0, **kw):
    cfg_j = jconfigs.get_smoke_config(arch).scaled(compute_dtype=dtype,
                                                   **kw)
    cfg = configs.get_smoke_config(arch).scaled(compute_dtype=dtype, **kw)
    params = jnn.init_params(jregistry.param_specs(cfg_j),
                             jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return cfg_j, params, cfg, transformer_from_numpy(cfg, tree, "cpu")


def _tokens(cfg, B, T, seed=4):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, T),
                                                dtype=np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_f32_matches_reference(case, one_device_mesh):
    """The moe model's logits, loss and prefill caches in f32 against the
    jitted ``registry.logits_fn`` / ``loss_fn`` / ``prefill_fn``, within
    the dense tests' 1e-5 (logits, caches) and 1e-6 relative (loss)."""
    arch, kw = CASES[case]
    cfg_j, params, cfg, model = _models(arch, **kw)
    tokens = _tokens(cfg, 2, 13)
    batch_j, batch = ({"tokens": jnp.asarray(tokens)},
                      {"tokens": torch.from_numpy(tokens)})
    lj = np.asarray(jax.jit(lambda p, b: jregistry.logits_fn(cfg_j, p, b))(
        params, batch_j))
    with torch.no_grad():
        lt = registry.logits_fn(cfg, model, batch)
    np.testing.assert_allclose(lt.numpy(), lj, atol=1e-5, rtol=0)
    loss_j = float(jax.jit(jregistry.loss_fn(cfg_j))(params, batch_j))
    # the loss takes a tree in the reference's layout
    loss_t = float(registry.loss_fn(cfg)(_to_torch(params), batch))
    assert loss_t == pytest.approx(loss_j, rel=1e-6)
    (lastj, (kj, vj)) = jax.jit(jregistry.prefill_fn(cfg_j))(params, batch_j)
    with torch.no_grad():
        last, (kt, vt) = registry.prefill_fn(cfg)(model, batch)
    np.testing.assert_allclose(last.numpy(), np.asarray(lastj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5,
                               rtol=0)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_decode_step_matches_reference(one_device_mesh):
    """One decode step of the moe model against a prefill cache (f32),
    against ``registry.serve_fn``, and the slot-pool step the engine runs
    on the same cache rows."""
    cfg_j, params, cfg, model = _models("dbrx-132b", top_k=4)
    tokens = _tokens(cfg, 3, 7, seed=5)
    nxt = _tokens(cfg, 3, 1, seed=6)
    _, (kj, vj) = jax.jit(jregistry.prefill_fn(cfg_j))(
        params, {"tokens": jnp.asarray(tokens)})
    lj, (nkj, _) = jax.jit(jregistry.serve_fn(cfg_j))(
        params, {"tokens": jnp.asarray(nxt)}, {"k": kj, "v": vj})
    with torch.no_grad():
        _, (kt, vt) = registry.prefill_fn(cfg)(
            model, {"tokens": torch.from_numpy(tokens)})
        lt, (nkt, _) = registry.serve_fn(cfg)(
            model, {"tokens": torch.from_numpy(nxt)}, {"k": kt, "v": vt})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(nkt.numpy(), np.asarray(nkj), atol=1e-5,
                               rtol=0)


def test_model_bf16_error_within_twice_the_reference(one_device_mesh):
    """The moe model in bf16 (dbrx's smoke at top 4, head_dim 32): the
    port's logits' error against the f32 model (the JAX one) at most
    twice the JAX bf16 model's own (relative L2, and max|diff| against
    max|f32|).  Routing may flip on near ties in both, as the bar
    allows."""
    kw = {"top_k": 4}
    cfg_j32, params, _, _ = _models("dbrx-132b", **kw)
    cfg_j, _, cfg, model = _models("dbrx-132b", "bfloat16", **kw)
    tokens = _tokens(cfg, 2, 24, seed=8)
    batch_j = {"tokens": jnp.asarray(tokens)}
    l32 = np.asarray(jax.jit(lambda p, b: jregistry.logits_fn(
        cfg_j32, p, b))(params, batch_j))
    ljb = np.asarray(jax.jit(lambda p, b: jregistry.logits_fn(cfg_j, p, b))(
        params, batch_j).astype(jnp.float32))
    with torch.no_grad():
        ltb = registry.logits_fn(cfg, model,
                                 {"tokens": torch.from_numpy(tokens)})
    ltb = ltb.float().numpy()
    ej, et = np.linalg.norm(ljb - l32), np.linalg.norm(ltb - l32)
    assert ej > 0
    assert et <= 2 * ej, (et, ej)
    assert (np.abs(ltb - l32).max()
            <= 2 * max(np.abs(ljb - l32).max(), 2.0 ** -8 * np.abs(l32).max()))
