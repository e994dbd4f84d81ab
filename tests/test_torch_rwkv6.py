"""The port's rwkv6 against the JAX package (``repro.models.rwkv6``): the
plain versions of the ``wkv6`` kernels against the reference's
recurrence (its scan, its decode step, ``jax.grad``), and the model, its
serve path and its train step against the reference's, with the
reference's parameters carried across as numpy arrays.  The recurrence is
held at heads of K = 64 (the full config's), the model at the smoke
config; the zero-initialised leaves (the mixes, the bonus u and the decay
bias) are drawn nonzero, so the bonus term and its gradient are checked.
The reference runs jitted on a one-device mesh (its ``shard_activation``
raises under jax's Explicit mesh axes on a multi-device mesh)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import compress as jcomp
from repro.dist import meshctx
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro.models import rwkv6 as jrwkv6
from repro.optim import optimizers as joptim
from repro.serve import ServeEngine as JServeEngine
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.convert import params_from_numpy, rwkv6_from_numpy
from repro_torch.dist import compress as tcomp
from repro_torch.kernels import ops, ref
from repro_torch.models import registry, rwkv6
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.serve import ServeEngine, naive_generate
from repro_torch.train import steps

ARCH = "rwkv6-1.6b"
LR = 3e-4
# the leaves the reference initialises to zeros, drawn nonzero here
ZERO_LEAVES = ("tm_mix", "cm_mix", "u_bonus", "decay_bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (the plain
    recurrence is thousands of tiny ops), as tests/test_torch_train.py: the
    test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_device_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])
    monkeypatch.setattr(meshctx, "_mesh", mesh)
    return mesh


def _cfgs(dtype="float32", **kw):
    return (jconfigs.get_smoke_config(ARCH).scaled(compute_dtype=dtype, **kw),
            configs.get_smoke_config(ARCH).scaled(compute_dtype=dtype, **kw))


def _params(cfg_j, seed=0):
    """The reference's parameter tree under its init law, drawn with numpy
    from ``seed`` (f32), with the zero-initialised leaves drawn from
    N(0, 0.5^2) and the norms' ones perturbed by N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        name = path[-1].key
        if name in ZERO_LEAVES:
            x = 0.5 * rng.standard_normal(spec.shape)
        elif spec.init == "ones":
            x = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        elif spec.init == "embed" or len(spec.shape) < 2:
            x = spec.scale * 0.02 * rng.standard_normal(spec.shape)
        else:
            x = (spec.scale / np.sqrt(max(spec.shape[-2], 1))
                 * rng.standard_normal(spec.shape))
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(
        make, jregistry.param_specs(cfg_j),
        is_leaf=lambda x: isinstance(x, jnn.ParamSpec))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape,
                                                dtype=np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _recurrence_inputs(B=2, T=200, H=2, K=64, seed=0):
    """r, k, v (B, T, H, K), a decay w in (0, 1) and u (H, K), f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((B, T, H, K)) - 0.5))
    u = 0.5 * rng.standard_normal((H, K))
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


# ----------------------------------------------------------- recurrence
def test_wkv6_ref_matches_the_reference_scan():
    """f32, K = 64, a ragged T = 200 over the reference's 128-step chunks:
    ``wkv6_ref`` against the jitted ``_wkv_scan``, y and the final state
    within 1e-6 of their max (measured ~2e-7: the two libraries sum
    r (S + u kv) in other orders)."""
    B, T, H, K = 2, 200, 2, 64
    r, k, v, w, u = _recurrence_inputs(B, T, H, K)
    scan = jax.jit(lambda *a: jrwkv6._wkv_scan(*a, H, K))
    jy, js = scan(*(jnp.asarray(a.reshape(B, T, H * K)) for a in (r, k, v, w)),
                  jnp.asarray(u.reshape(-1)))
    t = torch.from_numpy
    y, s = ref.wkv6_ref(t(r), t(k), t(v), t(w), t(u))
    assert y.dtype == s.dtype == torch.float32
    assert _rel(y.numpy().reshape(B, T, H * K), jy) <= 1e-6
    assert _rel(s.numpy(), js) <= 1e-6
    # the kept states are the loop's own, every ref.WKV_CHUNK (64) steps
    y2, s2, chunks = ref.wkv6_ref(t(r), t(k), t(v), t(w), t(u),
                                  return_chunks=True)
    assert torch.equal(y2, y) and torch.equal(s2, s)
    C = ref.WKV_CHUNK
    assert chunks.shape == (B, H, -(-T // C), K, K)
    assert not bool(chunks[:, :, 0].any())
    _, s64 = ref.wkv6_ref(*(t(a[:, :C]) for a in (r, k, v, w)), t(u))
    assert torch.equal(chunks[:, :, 1], s64)


def test_wkv6_ref_with_state_matches_the_reference_decode_chain(
        one_device_mesh):
    """``ops.wkv6`` with a state at T = 1 is the reference's decode step:
    12 chained ``time_mix`` decode steps (heads of K = 64, f32, nonzero
    mixes, bonus and decay bias) give the reference's outputs, states and
    shift tokens (within 1e-6 of their max)."""
    cfg_j, cfg = _cfgs(d_model=128, n_heads=2, n_kv_heads=2)
    p = _params(cfg_j)["layers"]
    pj = jax.tree.map(lambda a: a[0], p)
    pt = rwkv6.Rwkv6Layer({k: torch.from_numpy(np.array(a))
                           for k, a in pj.items()})
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((12, 2, 1, 128)).astype(np.float32)
    step = jax.jit(lambda x, s, prev: jrwkv6.time_mix(cfg_j, pj, x, s, prev))
    js = jnp.asarray(0.3 * rng.standard_normal((2, 2, 64, 64)),
                     jnp.float32)
    jprev = jnp.zeros((2, 1, 128), jnp.float32)
    ts, tprev = torch.from_numpy(np.array(js)), torch.from_numpy(
        np.array(jprev))
    for x in xs:
        jout, js, jprev = step(jnp.asarray(x), js, jprev)
        tout, ts, tprev = rwkv6.time_mix(cfg, pt, torch.from_numpy(x), ts,
                                         tprev)
        assert _rel(tout.numpy(), jout) <= 1e-6
        assert _rel(ts.numpy(), js) <= 1e-6
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))


def test_wkv6_bwd_ref_matches_jax_grad_and_autograd():
    """The reverse-time gradient at K = 64, T = 200: against ``jax.grad`` of
    the jitted ``_wkv_scan`` (zero first state; dr, dk, dv, dw, du) and
    against torch autograd of ``wkv6_ref`` (with a first state and a final
    state's gradient; every output and dS0), each within 1e-5 of its
    max|g|."""
    B, T, H, K = 2, 200, 2, 64
    r, k, v, w, u = _recurrence_inputs(B, T, H, K, seed=1)
    rng = np.random.default_rng(2)
    dy = rng.standard_normal((B, T, H, K)).astype(np.float32)
    ds = (0.1 * rng.standard_normal((B, H, K, K))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((B, H, K, K))).astype(np.float32)

    def jloss(r_, k_, v_, w_, u_):
        y, s = jrwkv6._wkv_scan(r_, k_, v_, w_, u_, H, K)
        return (jnp.sum(y * jnp.asarray(dy.reshape(B, T, H * K)))
                + jnp.sum(s * jnp.asarray(ds)))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *(jnp.asarray(a.reshape(B, T, H * K)) for a in (r, k, v, w)),
        jnp.asarray(u.reshape(-1)))
    t = torch.from_numpy
    got = ref.wkv6_bwd_ref(t(r), t(k), t(v), t(w), t(u), t(dy), None, t(ds))
    for a, b in zip(got[:5], jg):
        assert _rel(a.numpy().reshape(b.shape), b) <= 1e-5
    ins = [t(a).requires_grad_() for a in (r, k, v, w, u, s0)]
    y, s = ref.wkv6_ref(*ins)
    want = torch.autograd.grad((y * t(dy)).sum() + (s * t(ds)).sum(), ins)
    got = ref.wkv6_bwd_ref(t(r), t(k), t(v), t(w), t(u), t(dy), t(s0), t(ds))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b.numpy()) <= 1e-5


def test_wkv6_op_gradients_in_the_inputs_dtypes():
    """``ops.wkv6`` under autograd on the CPU (the plain versions):
    gradients come back in each input's dtype (bf16 r, k, v and w, f32 u
    and state), equal to ``wkv6_bwd_ref`` rounded to it; the shapes the
    kernels refuse are refused here too."""
    r, k, v, w, u = (torch.from_numpy(a) for a in
                     _recurrence_inputs(1, 40, 2, 16, seed=4))
    ins = [a.bfloat16().requires_grad_() for a in (r, k, v, w)]
    uu = u.clone().requires_grad_()
    s0 = torch.randn((1, 2, 16, 16), generator=torch.Generator().manual_seed(
        0)).requires_grad_()
    y, s = ops.wkv6(*ins, uu, s0)
    dy = torch.randn_like(y)
    grads = torch.autograd.grad((y * dy).sum() + s.sum(), ins + [uu, s0])
    want = ref.wkv6_bwd_ref(*(a.detach() for a in ins), u, dy, s0.detach(),
                            torch.ones_like(s))
    for g, a, wt in zip(grads, ins + [uu, s0], want):
        assert g.dtype == a.dtype
        assert torch.equal(g, wt.to(a.dtype))
    with pytest.raises(ValueError, match="head dim"):
        ops.wkv6(*(torch.zeros((1, 3, 2, 8)) for _ in range(4)),
                 torch.zeros((2, 8)))
    with pytest.raises(TypeError):
        ops.wkv6(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError, match="f32 decay"):
        ops.wkv6(r, k, v, w.bfloat16(), u)


# ---------------------------------------------------------------- model
def _model_from(cfg, params):
    return rwkv6_from_numpy(cfg, _np(params), "cpu")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_logits_match_reference(remat, one_device_mesh):
    """f32 logits of the scan path (``registry.logits_fn``, under autograd
    so that ``remat`` full checkpoints each layer) within 1e-5 of the
    jitted reference's max|logit|; ``prefill_fn`` returns the last
    position's and no cache, as the reference's."""
    cfg_j, cfg = _cfgs(remat=remat)
    params = _params(cfg_j)
    tokens = _tokens(cfg, (2, 40))
    want = jax.jit(lambda p, t: jregistry.logits_fn(cfg_j, p, {"tokens": t}))(
        params, jnp.asarray(tokens))
    tree = params_from_numpy(_np(params), "cpu")
    leaves = [x.requires_grad_() for x in tcomp._flatten(tree)[0]]
    assert leaves
    got = registry.logits_fn(cfg, rwkv6.TreeModel(cfg, tree),
                             {"tokens": torch.from_numpy(tokens)})
    assert got.requires_grad
    assert _rel(got.detach().numpy(), want) <= 1e-5
    model = _model_from(cfg, params)
    with torch.no_grad():
        last, cache = registry.prefill_fn(cfg)(
            model, {"tokens": torch.from_numpy(tokens)})
    assert cache is None and last.shape == (2, 1, cfg.padded_vocab)
    assert _rel(last.numpy(), np.asarray(want)[:, -1:]) <= 1e-5


def test_prefill_and_decode_match_reference(one_device_mesh):
    """f32: ``rwkv6.prefill`` (a loop of one-token decodes) gives the
    reference's last logits and state (wkv, both shift tokens), then two
    ``decode`` steps give its logits and states (within 1e-5 of their
    max); the state's shapes and dtypes are ``decode_state_specs``'."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    model = _model_from(cfg, params)
    tokens = _tokens(cfg, (2, 9), seed=4)
    jl, js = jax.jit(lambda p, t: jrwkv6.prefill(cfg_j, p, t))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        tl, ts = rwkv6.prefill(cfg, model, torch.from_numpy(tokens))
    specs = registry.decode_state_specs(cfg, 2, 64)
    assert sorted(ts) == sorted(js) == sorted(specs)
    for key in ts:
        assert ts[key].shape == specs[key].shape == js[key].shape
        assert ts[key].dtype == specs[key].dtype
    assert _rel(tl.numpy(), jl) <= 1e-5
    for key in ts:
        assert _rel(ts[key].numpy(), js[key]) <= 1e-5, key
    dec = jax.jit(lambda p, t, s: jrwkv6.decode(cfg_j, p, t, s))
    serve = registry.serve_fn(cfg)
    for i in range(2):
        tok = _tokens(cfg, (2, 1), seed=20 + i)
        jl, js = dec(params, jnp.asarray(tok), js)
        with torch.no_grad():
            tl, ts = serve(model, {"tokens": torch.from_numpy(tok)}, ts)
        assert _rel(tl.numpy(), jl) <= 1e-5
        for key in ts:
            assert _rel(ts[key].numpy(), js[key]) <= 1e-5, key


def test_bf16_within_twice_the_reference_and_the_paths_differ_as_its(
        one_device_mesh):
    """bf16 (f32 parameters, the compute cast at use on both sides): the
    forward's logits no further from the reference's f32 logits than
    twice the reference's own bf16 forward (relative L2 and max); and the
    scan path's last logits differ from ``prefill``'s (the decode path,
    whose decay stays f32) as the reference's do: by about the same share
    of max|logit| (within a factor 2; a few percent), while in f32 the two
    paths agree within 1e-5."""
    cfg_j, cfg = _cfgs("bfloat16")
    params = _params(cfg_j)
    model = _model_from(cfg, params)
    tokens = _tokens(cfg, (2, 200), seed=6)
    jt = jnp.asarray(tokens)
    fwd = jax.jit(lambda c, p, t: jrwkv6.forward(c, p, t), static_argnums=0)
    want = np.asarray(fwd(cfg_j.scaled(compute_dtype="float32"), params, jt))
    jbf = np.asarray(fwd(cfg_j, params, jt).astype(jnp.float32))
    with torch.no_grad():
        got = rwkv6.forward(cfg, model, torch.from_numpy(tokens)).float()
        tgap_l, _ = rwkv6.prefill(cfg, model, torch.from_numpy(tokens))
    got = got.numpy()

    def l2(a):
        return np.linalg.norm(a - want) / np.linalg.norm(want)

    assert l2(got) <= 2 * l2(jbf)
    assert _rel(got, want) <= 2 * _rel(jbf, want)
    jpre, _ = jax.jit(lambda p, t: jrwkv6.prefill(cfg_j, p, t))(params, jt)
    jgap = _rel(jbf[:, -1:], np.asarray(jpre.astype(jnp.float32)))
    tgap = _rel(got[:, -1:], tgap_l.float().numpy())
    assert 0.5 * jgap <= tgap <= 2 * jgap
    assert jgap > 1e-3
    cfg32 = cfg.scaled(compute_dtype="float32")
    with torch.no_grad():
        a = rwkv6.forward(cfg32, model, torch.from_numpy(tokens[:, :40]),
                          last_only=True)
        b, _ = rwkv6.prefill(cfg32, model, torch.from_numpy(tokens[:, :40]))
    assert _rel(a.numpy(), b.numpy()) <= 1e-5


# ---------------------------------------------------------------- train
def _tleaves(tree):
    return [x.detach().numpy() for x in tcomp._flatten(tree)[0]]


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradient_match_reference(remat, one_device_mesh):
    """f32, batch 2 x 48: ``registry.loss_fn``'s value within 1e-5
    relative and every gradient leaf (the mixes, u and the decay bias
    among them) within 1e-4 max|g| of ``jax.value_and_grad``'s."""
    cfg_j, cfg = _cfgs(remat=remat)
    params = _params(cfg_j)
    tokens = _tokens(cfg, (2, 48), seed=8)
    jl, jg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))(
        params, {"tokens": jnp.asarray(tokens)})
    tl, tg = steps.value_and_grad(cfg, params_from_numpy(_np(params), "cpu"),
                                  {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    got, want = _tleaves(tg), _jleaves(jg)
    assert len(got) == len(want) == 19
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float(np.abs(b).max()) > 0
        assert _rel(a, b) <= 1e-4


ADAM_BOUND = (1 - 0.9) / (np.sqrt(1 - 0.95) * (1 - 0.9 / np.sqrt(0.95)))


def test_train_step_matches_the_jitted_reference(one_device_mesh):
    """One step of the launcher's configuration (AdamW, lr 3e-4,
    aggregate_gaussian fused b = 8 per-tensor, 2 microbatches) against
    ``jax.jit(steps.build_train_step)``, as tests/test_torch_train.py
    feeds it: the loss within 1e-5 relative, every parameter within
    2 B lr (B the AdamW bound) and 99.9% within 1e-6 relative + 1e-9."""
    cfg_j, cfg = _cfgs()
    kw = dict(mechanism="aggregate_gaussian", sigma=1e-3, fused=True,
              msg_bits=8, per_coord=False)
    jtc = jsteps.TrainConfig(lr=LR, grad_accum=2,
                             compression=jcomp.CompressionConfig(**kw))
    ttc = steps.TrainConfig(lr=LR, grad_accum=2,
                            compression=tcomp.CompressionConfig(**kw))
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    params = _params(cfg_j)
    jstate = {"params": params,
              "opt_state": joptim.get_optimizer("adamw", LR).init(params),
              "step": jnp.zeros((), jnp.int32)}
    tp = params_from_numpy(_np(params), "cpu")
    tstate = {"params": tp, "opt_state": get_optimizer("adamw", LR).init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    tokens = _tokens(cfg, (4, 32), seed=21)
    jstate, jm = jax.jit(jsteps.build_train_step(cfg_j, jtc, mesh))(
        jstate, {"tokens": jnp.asarray(tokens)}, jnp.int32(5))
    tstate, tm = steps.build_train_step(cfg, ttc)(
        tstate, {"tokens": torch.from_numpy(tokens)}, 5)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
        1e-5 * abs(float(jm["loss"])))
    n = bad = 0
    for a, b in zip(_tleaves(tstate["params"]), _jleaves(jstate["params"])):
        assert float(np.abs(a - b).max()) <= 2 * ADAM_BOUND * LR
        bad += int((np.abs(a - b) > 1e-6 * np.abs(b) + 1e-9).sum())
        n += a.size
    assert bad <= 1e-3 * n


# ---------------------------------------------------------------- serve
def test_engine_equals_naive_loop_and_reference_engine(one_device_mesh):
    """f32: the engine (each prompt prefilled by one-token decodes, a slot
    finishing early) gives the port's naive loop's tokens and the
    reference engine's, token for token; a request's engine prefill is
    bitwise its own chain of ``serve_fn`` calls."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    model = _model_from(cfg, params)
    N, P, G = 3, 7, 8
    prompts = _tokens(cfg, (N, P), seed=11)
    jeng = JServeEngine(cfg_j, max_slots=N, max_prefill_len=P, max_gen_len=G)
    teng = ServeEngine(cfg, max_slots=N, max_prefill_len=P, max_gen_len=G,
                       device="cpu")
    assert teng.family.capacity is None
    jstate, tstate = jeng.init_state(), teng.init_state()
    prefixes = []
    for i in range(N):
        _, jp = jeng.prefill(params, prompts[i])
        jstate = jeng.insert(jstate, jp, i, max_gen=4 if i == 1 else G)
        _, tp = teng.prefill(model, prompts[i])
        prefixes.append(tp)
        tstate = teng.insert(tstate, tp, i, max_gen=4 if i == 1 else G)
    want, got = [np.asarray(jstate["tokens"])], [tstate["tokens"].numpy()]
    for _ in range(G - 1):
        jstate, jt, _ = jeng.generate_step(params, jstate)
        tstate, tt, _ = teng.generate_step(model, tstate)
        want.append(np.asarray(jt))
        got.append(tt.numpy())
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_array_equal(got, want)
    naive = naive_generate(cfg, model, {"tokens": torch.from_numpy(prompts)},
                           G).numpy()
    np.testing.assert_array_equal(naive[[0, 2]], got[[0, 2]])
    np.testing.assert_array_equal(naive[1, :4], got[1, :4])
    serve = registry.serve_fn(cfg)
    cache = registry.init_decode_state(cfg, 1, P, "cpu")
    with torch.no_grad():
        for t in range(P):
            logits, cache = serve(model, {"tokens": torch.from_numpy(
                prompts[:1, t:t + 1])}, cache)
    assert torch.equal(logits, prefixes[0].last_logits)
    for key in cache:
        assert torch.equal(cache[key], prefixes[0].cache[key]), key


def test_inactive_slots_frozen_bitwise():
    """A step with one slot inactive leaves that slot's state (every leaf,
    along axis 1) bitwise as it was and changes the active one's; a fully
    inactive pool keeps every bookkeeping tensor."""
    _, cfg = _cfgs()
    from repro_torch.launch import serve as launch

    model = launch.build_model(cfg, 0, "cpu")
    prompts = _tokens(cfg, (2, 5), seed=5)
    eng = ServeEngine(cfg, max_slots=2, max_prefill_len=5, max_gen_len=8,
                      device="cpu")
    state = eng.init_state()
    for i in range(2):
        _, prefix = eng.prefill(model, prompts[i])
        state = eng.insert(state, prefix, i, max_gen=8)
    state, _, _ = eng.generate_step(model, state)
    state = dict(state, active=torch.tensor([False, True]))
    before = {k: v.clone() for k, v in state["cache"].items()}
    stepped, _, _ = eng.generate_step(model, state)
    for k, old in before.items():
        assert torch.equal(stepped["cache"][k][:, 0], old[:, 0]), k
        assert not torch.equal(stepped["cache"][k][:, 1], old[:, 1]), k
    frozen = dict(stepped, active=torch.zeros((2,), dtype=torch.bool))
    before = {k: v.clone() for k, v in frozen["cache"].items()}
    out, tok, done = eng.generate_step(model, frozen)
    assert not bool(done.any())
    for k in before:
        assert torch.equal(out["cache"][k], before[k]), k
    for k in ("tokens", "lengths", "gen", "max_gen", "active"):
        assert torch.equal(out[k], frozen[k]), k


def test_converter_and_init():
    """``rwkv6_from_numpy`` keeps the reference's tree under its names (one
    module per layer, each leaf its stack's slice); ``init_model`` draws
    the reference's specs in the compute dtype; the engine and the naive
    loop refuse nothing for rwkv6, and whisper still raises."""
    cfg_j, cfg = _cfgs()
    params = _np(_params(cfg_j))
    model = rwkv6_from_numpy(cfg, params, "cpu")
    assert len(model.layers) == cfg.n_layers
    for name, stack in params["layers"].items():
        for i, lp in enumerate(model.layers):
            np.testing.assert_array_equal(getattr(lp, name).numpy(), stack[i])
    for name in ("embed", "final_w", "lm_head"):
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      params[name])
    gen = torch.Generator().manual_seed(0)
    bf = registry.init_model(cfg.scaled(compute_dtype="bfloat16"), gen, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    want = sum(np.prod(s.shape) for s in jax.tree.leaves(
        jregistry.param_specs(cfg_j),
        is_leaf=lambda x: isinstance(x, jnn.ParamSpec)))
    assert sum(p.numel() for p in bf.parameters()) == want
    with pytest.raises(NotImplementedError, match="frames"):
        ServeEngine(cfg.scaled(kind="whisper"), device="cpu")


def test_full_config_parameter_count():
    """rwkv6-1.6b: 1,678.3 M parameters in the specs, as in the
    reference's; 32 heads of K = 64."""
    from repro_torch.models import nn

    cfg = configs.get_config(ARCH)
    n = nn.spec_numel(registry.param_specs(cfg))
    want = sum(np.prod(s.shape) for s in jax.tree.leaves(
        jregistry.param_specs(jconfigs.get_config(ARCH)),
        is_leaf=lambda x: isinstance(x, jnn.ParamSpec)))
    assert n == want
    assert round(n / 1e6, 1) == 1678.3
    assert rwkv6.heads(cfg) == (32, 64)
