"""The port's zamba2 (Mamba2 blocks and a shared sliding-window attention
block) against the JAX package (``repro.models.mamba2`` and
``repro.models.zamba2``), with the reference's parameters carried across
as numpy arrays: the SSD block and its decode step, the model's scan path,
its decode chain (past the window, so the KV rings wrap), the serve engine
and the naive loop, the loss and its gradient, the converter, the full
config's size, and one bf16 case at zamba2-7b's head dim 112.  The smoke
config (7 layers: 2 groups of 2 Mamba2 layers and the shared block, a
tail of 1; window 16, SSD chunks of 8) with the zero- and one-initialised
leaves drawn off their init, so the decay, dt bias and skip terms are
checked.  The reference runs jitted on a one-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import meshctx
from repro.models import mamba2 as jmamba2
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro.models import zamba2 as jzamba2
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_numpy, zamba2_from_numpy
from repro_torch.dist import compress as tcomp
from repro_torch.models import mamba2, nn, registry, zamba2
from repro_torch.serve import ServeEngine, naive_generate
from repro_torch.train import steps

ARCH = "zamba2-7b"
# the leaves the reference initialises to zeros, drawn nonzero here
ZERO_LEAVES = ("A_log", "dt_bias")
# f32 bar of the 7-layer model's outputs (logits, states) against the
# reference's max: f32 sums in other orders compound over the layers
# (measured 9e-7 after one Mamba2 layer, 4e-6 after two, 1.7e-5 after all
# seven; the block alone is held to 1e-5)
MODEL_REL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors (the workers
    share the machine's cores), as tests/test_torch_rwkv6.py."""
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


def _draw(rng, path, spec):
    name = path[-1]
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


def _params(cfg_j, seed=0):
    """The reference's parameter tree under its init law, drawn with numpy
    from ``seed`` (f32): A_log and dt_bias from N(0, 0.5^2), the ones
    perturbed by N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, spec: _draw(rng, [p.key for p in path], spec),
        jregistry.param_specs(cfg_j),
        is_leaf=lambda x: isinstance(x, jnn.ParamSpec))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape,
                                                dtype=np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _model(cfg, params):
    return zamba2_from_numpy(cfg, _np(params), "cpu")


# ---------------------------------------------------------------- mamba2
def test_mamba2_block_and_decode_match_reference(one_device_mesh):
    """f32, the first group's first layer: ``mamba2_block`` over T = 40
    (five SSD chunks of 8) gives the jitted reference's output and final
    state, and 6 chained ``mamba2_decode`` steps from a nonzero state its
    outputs and states, each within 1e-5 of its max; a T that is not a
    multiple of the chunk raises, as the reference's reshape does."""
    cfg_j, cfg = _cfgs()
    pj = jax.tree.map(lambda a: a[0, 0], _params(cfg_j)["groups"])
    pt = zamba2.Mamba2Layer({k: torch.from_numpy(np.array(a))
                             for k, a in pj.items()})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jy, js = jax.jit(lambda p, x: jmamba2.mamba2_block(cfg_j, p, x))(
        pj, jnp.asarray(x))
    ty, ts = mamba2.mamba2_block(cfg, pt, torch.from_numpy(x))
    assert ty.shape == jy.shape and ts.shape == js.shape
    assert _rel(ty.numpy(), jy) <= 1e-5
    assert _rel(ts.numpy(), js) <= 1e-5
    with pytest.raises(ValueError, match="multiple"):
        mamba2.mamba2_block(cfg, pt, torch.from_numpy(x[:, :12]))
    step = jax.jit(lambda p, x, s: jmamba2.mamba2_decode(cfg_j, p, x, s))
    H, P, N = mamba2.heads(cfg)
    js = jnp.asarray(0.3 * rng.standard_normal((2, H, P, N)), jnp.float32)
    ts = torch.from_numpy(np.array(js))
    for _ in range(6):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, js = step(pj, jnp.asarray(xt), js)
        ty, ts = mamba2.mamba2_decode(cfg, pt, torch.from_numpy(xt), ts)
        assert _rel(ty.numpy(), jy) <= 1e-5
        assert _rel(ts.numpy(), js) <= 1e-5


def test_softplus_is_logaddexp_past_torchs_threshold():
    """dt's softplus is the reference's ``logaddexp(x, 0)`` past torch's
    softplus threshold of 20 too, where torch's returns x itself."""
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 20.5, 25.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    got = torch.logaddexp(x, torch.zeros(()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_logits_match_reference(remat, one_device_mesh):
    """f32 logits of the scan path (``registry.logits_fn`` under autograd,
    so ``remat`` full checkpoints each layer) over T = 32, past the
    window of 16, within MODEL_REL of the jitted reference's max|logit|;
    ``prefill_fn`` returns the last position's logits and no cache."""
    cfg_j, cfg = _cfgs(remat=remat)
    params = _params(cfg_j)
    tokens = _tokens(cfg, (2, 32))
    want = jax.jit(lambda p, t: jregistry.logits_fn(cfg_j, p, {"tokens": t}))(
        params, jnp.asarray(tokens))
    tree = params_from_numpy(_np(params), "cpu")
    for x in tcomp._flatten(tree)[0]:
        x.requires_grad_()
    got = registry.logits_fn(cfg, zamba2.TreeModel(cfg, tree),
                             {"tokens": torch.from_numpy(tokens)})
    assert got.requires_grad
    assert _rel(got.detach().numpy(), want) <= MODEL_REL
    with torch.no_grad():
        last, cache = registry.prefill_fn(cfg)(
            _model(cfg, params), {"tokens": torch.from_numpy(tokens)})
    assert cache is None and last.shape == (2, 1, cfg.padded_vocab)
    assert _rel(last.numpy(), np.asarray(want)[:, -1:]) <= MODEL_REL


def test_prefill_and_decode_match_reference(one_device_mesh):
    """f32: ``zamba2.prefill`` (one-token decodes into a ring of the window's
    16 rows) over 24 tokens, so the rings wrap, gives the reference's last
    logits and state (every leaf within MODEL_REL of its max; kv_pos and
    pos equal), and its last logits those of the scan path within
    MODEL_REL; then
    two ``serve_fn`` steps give the reference's; the state's shapes and
    dtypes are ``decode_state_specs``'."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    model = _model(cfg, params)
    tokens = _tokens(cfg, (2, 24), seed=4)
    W = cfg.window
    jl, js = jax.jit(lambda p, t: jzamba2.prefill(cfg_j, p, t, W))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        tl, ts = zamba2.prefill(cfg, model, torch.from_numpy(tokens), W)
        scan = zamba2.forward(cfg, model, torch.from_numpy(tokens),
                              last_only=True)
    specs = registry.decode_state_specs(cfg, 2, 64)
    assert sorted(ts) == sorted(js) == sorted(specs)
    for key in ts:
        assert ts[key].shape == specs[key].shape == js[key].shape, key
        assert ts[key].dtype == specs[key].dtype, key
    assert _rel(tl.numpy(), jl) <= MODEL_REL
    assert _rel(scan.numpy(), tl.numpy()) <= MODEL_REL
    for key in ("kv_pos", "pos"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    for key in ("ssm_groups", "ssm_tail", "attn_k", "attn_v"):
        assert _rel(ts[key].numpy(), js[key]) <= MODEL_REL, key
    dec = jax.jit(lambda p, t, s: jzamba2.decode(cfg_j, p, t, s))
    serve = registry.serve_fn(cfg)
    for i in range(2):
        tok = _tokens(cfg, (2, 1), seed=20 + i)
        jl, js = dec(params, jnp.asarray(tok), js)
        with torch.no_grad():
            tl, ts = serve(model, {"tokens": torch.from_numpy(tok)}, ts)
        assert _rel(tl.numpy(), jl) <= MODEL_REL
        for key in ("ssm_groups", "attn_k", "attn_v"):
            assert _rel(ts[key].numpy(), js[key]) <= MODEL_REL, key


def test_bf16_head_dim_112_within_twice_the_reference(one_device_mesh):
    """bf16 at zamba2-7b's head dim 112 (d 224, 2 heads; 7 SSD heads of
    64) over T = 48, past the window: the port's scan-path logits no
    further from the reference's f32 logits than twice the reference's
    own bf16 forward (relative L2 and max)."""
    kw = dict(d_model=224, n_heads=2, n_kv_heads=2, d_ff=256)
    cfg_j, cfg = _cfgs("bfloat16", **kw)
    assert cfg.hd == 112
    params = _params(cfg_j, seed=5)
    tokens = jnp.asarray(_tokens(cfg, (2, 48), seed=6))
    fwd = jax.jit(lambda c, p, t: jzamba2.forward(c, p, t), static_argnums=0)
    want = np.asarray(fwd(cfg_j.scaled(compute_dtype="float32"), params,
                          tokens))
    jbf = np.asarray(fwd(cfg_j, params, tokens).astype(jnp.float32))
    with torch.no_grad():
        got = zamba2.forward(cfg, _model(cfg, params),
                             torch.from_numpy(np.array(tokens)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    def l2(a):
        return np.linalg.norm(a - want) / np.linalg.norm(want)

    assert l2(got) <= 2 * l2(jbf)
    assert _rel(got, want) <= 2 * _rel(jbf, want)


# ---------------------------------------------------------------- train
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradient_match_reference(remat, one_device_mesh):
    """f32, batch 2 x 32 (past the window): ``registry.loss_fn``'s value
    within 1e-5 relative and every gradient leaf within 1e-4 max|g| of
    ``jax.value_and_grad``'s; the shared block's leaves sum their two
    applications, and the Mamba2 ``norm_w`` the block never reads has a
    zero gradient on both sides."""
    cfg_j, cfg = _cfgs(remat=remat)
    params = _params(cfg_j)
    tokens = _tokens(cfg, (2, 32), seed=8)
    jl, jg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))(
        params, {"tokens": jnp.asarray(tokens)})
    tl, tg = steps.value_and_grad(cfg, params_from_numpy(_np(params), "cpu"),
                                  {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    got = [x.detach().numpy() for x in tcomp._flatten(tg)[0]]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
    # embed, 8 group stacks, the shared block's 9, final_w, lm_head, 8 tail
    assert len(got) == len(want) == 1 + 8 + 9 + 2 + 8
    zero = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if not np.abs(b).max():
            assert not np.abs(a).max()
            zero += 1
            continue
        assert _rel(a, b) <= 1e-4
    assert zero == 2  # norm_w of the groups and of the tail


def test_gradient_finite_where_the_reference_overflows(one_device_mesh):
    """At the full configs' SSD chunk of 128, from the reference's own init
    (A_log 0, dt_bias 0): the reference's gradient is NaN in every leaf
    upstream of a Mamba2 layer (exp(L_t - L_s) overflows above the
    diagonal and its masked zero is multiplied by inf), the port's, which
    masks before the exp, is finite; the losses agree within 1e-5
    relative, and the leaves the reference gets finite within 1e-4
    max|g| of it."""
    cfg_j, cfg = _cfgs(ssm_chunk=128, n_layers=3, d_model=128, n_heads=2,
                       n_kv_heads=2)
    rng = np.random.default_rng(0)

    def init(path, spec):
        if spec.init in ("zeros", "ones"):
            x = np.full(spec.shape, 0.0 if spec.init == "zeros" else 1.0)
        else:
            std = (0.02 if spec.init == "embed" or len(spec.shape) < 2
                   else 1 / np.sqrt(spec.shape[-2]))
            x = std * rng.standard_normal(spec.shape)
        return jnp.asarray(x.astype(np.float32))

    params = jax.tree_util.tree_map_with_path(
        init, jregistry.param_specs(cfg_j),
        is_leaf=lambda x: isinstance(x, jnn.ParamSpec))
    tokens = _tokens(cfg, (1, 256), seed=9)
    jl, jg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))(
        params, {"tokens": jnp.asarray(tokens)})
    tl, tg = steps.value_and_grad(cfg, params_from_numpy(_np(params), "cpu"),
                                  {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    got = [x.numpy() for x in tcomp._flatten(tg)[0]]
    want = [np.asarray(x) for x in jax.tree.leaves(jg)]
    nan = [bool(np.isnan(b).any()) for b in want]
    assert sum(nan) >= 8  # the embedding and the Mamba2 layers' leaves
    for a, b, bad in zip(got, want, nan):
        assert np.isfinite(a).all()
        if not bad and np.abs(b).max():
            assert _rel(a, b) <= 1e-4


# ---------------------------------------------------------------- serve
def test_engine_equals_naive_loop_and_reference_engine(one_device_mesh):
    """f32: the engine (prompts of 18 prefilled by one-token decodes into
    rings of the window's 16 rows, a slot finishing early) gives the port's
    naive loop's tokens and the reference engine's, token for token; a
    request's engine prefill is bitwise its own chain of ``serve_fn``
    calls; a step leaves an inactive slot's state bitwise as it was."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    model = _model(cfg, params)
    N, P, G = 3, 18, 8
    prompts = _tokens(cfg, (N, P), seed=11)
    jeng = JServeEngine(cfg_j, max_slots=N, max_prefill_len=P, max_gen_len=G)
    teng = ServeEngine(cfg, max_slots=N, max_prefill_len=P, max_gen_len=G,
                       device="cpu")
    assert teng.family.capacity is None
    assert teng.family.window_cache == cfg.window
    jstate, tstate = jeng.init_state(), teng.init_state()
    prefixes = []
    for i in range(N):
        _, jp = jeng.prefill(params, prompts[i])
        jstate = jeng.insert(jstate, jp, i, max_gen=4 if i == 1 else G)
        _, tp = teng.prefill(model, prompts[i])
        prefixes.append(tp)
        tstate = teng.insert(tstate, tp, i, max_gen=4 if i == 1 else G)
    want, got = [np.asarray(jstate["tokens"])], [tstate["tokens"].numpy()]
    for s in range(G - 1):
        jstate, jt, _ = jeng.generate_step(params, jstate)
        if s == 4:  # slot 1 finished after 4 tokens: frozen from here
            before = {k: v.clone() for k, v in tstate["cache"].items()}
        tstate, tt, _ = teng.generate_step(model, tstate)
        if s == 4:
            for k, old in before.items():
                a = teng.family._AXES[k]
                assert torch.equal(tstate["cache"][k].select(a, 1),
                                   old.select(a, 1)), k
        want.append(np.asarray(jt))
        got.append(tt.numpy())
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_array_equal(got, want)
    naive = naive_generate(cfg, model, {"tokens": torch.from_numpy(prompts)},
                           G).numpy()
    np.testing.assert_array_equal(naive[[0, 2]], got[[0, 2]])
    np.testing.assert_array_equal(naive[1, :4], got[1, :4])
    serve = registry.serve_fn(cfg)
    cache = registry.init_decode_state(cfg, 1, P + G, "cpu")
    with torch.no_grad():
        for t in range(P):
            logits, cache = serve(model, {"tokens": torch.from_numpy(
                prompts[:1, t:t + 1])}, cache)
    assert torch.equal(logits, prefixes[0].last_logits)
    for key in cache:
        assert torch.equal(cache[key], prefixes[0].cache[key]), key


# ------------------------------------------------------------ structure
def test_converter_init_and_launchers():
    """``zamba2_from_numpy`` keeps the reference's tree under its names
    (G lists of per-layer modules, the tail, one shared block), each leaf
    its stack's slice; ``init_model`` draws the reference's specs in the
    compute dtype; the serve launcher runs the smoke config on the CPU,
    engine and naive loop giving the same tokens."""
    cfg_j, cfg = _cfgs()
    params = _np(_params(cfg_j))
    model = zamba2_from_numpy(cfg, params, "cpu")
    G, pg, tail = zamba2.layout(cfg)
    assert (G, pg, tail) == (2, 2, 1)
    assert len(model.groups) == G and len(model.tail) == tail
    for name, stack in params["groups"].items():
        for g in range(G):
            for i in range(pg):
                np.testing.assert_array_equal(
                    getattr(model.groups[g][i], name).numpy(), stack[g, i])
    for name, stack in params["tail"].items():
        np.testing.assert_array_equal(getattr(model.tail[0], name).numpy(),
                                      stack[0])
    for name, leaf in params["shared_attn"]["attn"].items():
        np.testing.assert_array_equal(
            model.shared_attn.attn[name].numpy(), leaf)
    np.testing.assert_array_equal(model.shared_attn.norm2_w.numpy(),
                                  params["shared_attn"]["norm2_w"])
    gen = torch.Generator().manual_seed(0)
    bf = registry.init_model(cfg.scaled(compute_dtype="bfloat16"), gen, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    assert sum(p.numel() for p in bf.parameters()) == nn.spec_numel(
        registry.param_specs(cfg))
    from repro_torch.launch import serve as launch

    launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                 "2", "--slots", "2", "--prompt-len", "20", "--gen", "4"])


def test_full_config_parameter_count():
    """zamba2-7b: the specs' shapes are the reference's, 5,735.2 M
    parameters; 13 groups of 5 Mamba2 layers and a tail of 3; the shared
    attention's heads of 112 and the SSD's 112 heads of 64."""
    cfg = configs.get_config(ARCH)
    n = nn.spec_numel(registry.param_specs(cfg))
    want = sum(np.prod(s.shape) for s in jax.tree.leaves(
        jregistry.param_specs(jconfigs.get_config(ARCH)),
        is_leaf=lambda x: isinstance(x, jnn.ParamSpec)))
    assert n == want
    assert round(n / 1e6, 1) == 5735.2
    assert zamba2.layout(cfg) == (13, 5, 3)
    assert cfg.hd == 112 and cfg.window == 4096
    assert mamba2.heads(cfg) == (112, 64, 64)
