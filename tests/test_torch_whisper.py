"""The port's whisper (encoder-decoder) against the JAX package
(``repro.models.whisper``), with the reference's parameters carried
across as numpy arrays: the encoder, the forward and the prefill, the
decode step given the same self cache and cross K / V, a decode chain
against the teacher-forced forward, the loss and its gradient, the
converter, the frames stub, the full config's size, one bf16 case at
whisper-small's head dim 64, and the plain flash attention at whisper's
mask shapes (one query, T < S, non-causal, S past one 1024-key span).
The smoke config (2 encoder and 2 decoder layers, 8 frames) in f32; the
reference runs jitted on a one-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsyn
from repro.dist import meshctx
from repro.models import attention as jattn
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro.models import whisper as jwhisper
from repro_torch import configs
from repro_torch.convert import params_from_numpy, whisper_from_numpy
from repro_torch.core import prng
from repro_torch.data import synthetic as tsyn
from repro_torch.dist import compress as tcomp
from repro_torch.kernels import ops
from repro_torch.models import nn, registry, whisper
from repro_torch.serve import ServeEngine, naive_generate
from repro_torch.train import steps

ARCH = "whisper-small"
# f32 bar of the model's outputs against the reference's max: f32 sums in
# other orders through 2 + 2 layers (measured 3e-7 for the logits)
MODEL_REL = 1e-5
# the flash bars of tests/test_torch_flash_attention.py
ATOL = 2e-5
BF16_P_BAR = 2.0 ** -9
BF16_SHARE = 0.99


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


def _draw(rng, spec):
    if spec.init == "ones":
        x = 1.0 + 0.1 * rng.standard_normal(spec.shape)
    elif spec.init in ("embed", "zeros") or len(spec.shape) < 2:
        # the biases and LayerNorm shifts drawn off their zero init
        x = 0.02 * rng.standard_normal(spec.shape)
    else:
        x = (spec.scale / np.sqrt(max(spec.shape[-2], 1))
             * rng.standard_normal(spec.shape))
    return jnp.asarray(x.astype(np.float32))


def _params(cfg_j, seed=0):
    """The reference's parameter tree under its init law, drawn with numpy
    from ``seed`` (f32), the ones perturbed by N(0, 0.1^2) and the zeros
    drawn from N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda spec: _draw(rng, spec),
                        jregistry.param_specs(cfg_j),
                        is_leaf=lambda x: isinstance(x, jnn.ParamSpec))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape,
                                                dtype=np.int32)


def _frames(cfg, B, seed=4):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, cfg.encoder_len, cfg.d_model))
            ).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _model(cfg, params):
    return whisper_from_numpy(cfg, _np(params), "cpu")


def _cross_kv(cfg, model, frames):
    """The decode cache's cross K / V, (L, B, encoder_len, HK, hd) each:
    each decoder layer's ``cross.wk`` / ``cross.wv`` over the encoder
    memory, as ``_cross_attend`` projects them."""
    memory = whisper.encode(cfg, model, frames)
    B, S = memory.shape[:2]
    shape = (B, S, cfg.n_kv_heads, cfg.hd)
    return tuple(torch.stack([nn.dense(memory, lp.cross[w]).reshape(shape)
                              for lp in model.dec_layers])
                 for w in ("wk", "wv")), memory


def _self_cache(cfg, model, tokens, memory):
    """The decoder's self K / V of a prompt, (L, B, T, HK, hd) each, from
    its layers run in turn."""
    x = model.embed[tokens]
    rope = nn.rope_freqs(cfg.hd, x.shape[1] + 1, cfg.rope_theta, x.dtype)
    ks, vs = [], []
    for lp in model.dec_layers:
        x, (k, v) = whisper._dec_layer(cfg, lp, x, memory, rope)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("remat", ["none", "full"])
def test_encode_forward_and_prefill_match_reference(remat, one_device_mesh):
    """f32: ``encode`` gives the jitted reference's memory, and
    ``registry.logits_fn`` (under autograd, so ``remat`` full checkpoints
    each layer) its logits over T = 12 decoder tokens and 8 frames, within
    MODEL_REL of their max; ``prefill_fn`` returns the last position's
    logits and no cache."""
    cfg_j, cfg = _cfgs(remat=remat)
    params = _params(cfg_j)
    tokens, frames = _tokens(cfg, (2, 12)), _frames(cfg, 2)
    batch_j = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    batch = {"tokens": torch.from_numpy(tokens),
             "frames": torch.from_numpy(frames)}
    want_mem = jax.jit(lambda p, f: jwhisper.encode(cfg_j, p, f))(
        params, batch_j["frames"])
    want = jax.jit(lambda p, b: jregistry.logits_fn(cfg_j, p, b))(
        params, batch_j)
    tree = params_from_numpy(_np(params), "cpu")
    for x in tcomp._flatten(tree)[0]:
        x.requires_grad_()
    model = whisper.TreeModel(cfg, tree)
    got_mem = whisper.encode(cfg, model, batch["frames"])
    got = registry.logits_fn(cfg, model, batch)
    assert got.requires_grad and got.shape == want.shape
    assert got.shape[-1] == cfg.padded_vocab
    assert _rel(got_mem.detach().numpy(), want_mem) <= MODEL_REL
    assert _rel(got.detach().numpy(), want) <= MODEL_REL
    with torch.no_grad():
        last, cache = registry.prefill_fn(cfg)(_model(cfg, params), batch)
    jlast, jcache = jax.jit(lambda p, b: jregistry.prefill_fn(cfg_j)(p, b))(
        params, batch_j)
    assert cache is None and jcache is None
    assert last.shape == (2, 1, cfg.padded_vocab)
    assert _rel(last.numpy(), jlast) <= MODEL_REL


def test_decode_step_matches_reference(one_device_mesh):
    """f32: one ``serve_fn`` step over a self cache of 5 positions and the
    cross K / V of 8 frames (both drawn at random, the same on both sides)
    gives the reference's logits and new K / V within MODEL_REL; the cache
    tree is ``decode_state_specs``' (k, v, cross_k, cross_v)."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    model = _model(cfg, params)
    B, S, L = 2, 5, cfg.n_layers
    rng = np.random.default_rng(6)
    shape = (L, B, S, cfg.n_kv_heads, cfg.hd)
    cross = (L, B, cfg.encoder_len, cfg.n_kv_heads, cfg.hd)
    cache = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("k", shape), ("v", shape), ("cross_k", cross),
                          ("cross_v", cross))}
    specs = registry.decode_state_specs(cfg, B, S)
    jspecs = jregistry.decode_state_specs(cfg_j, B, S)
    assert sorted(specs) == sorted(jspecs) == sorted(cache)
    for key, s in specs.items():
        assert tuple(s.shape) == jspecs[key].shape == cache[key].shape
        assert s.dtype == torch.float32
    zeros = registry.init_decode_state(cfg, B, S, "cpu")
    assert all(not bool(zeros[k].any()) for k in zeros)
    tok = _tokens(cfg, (B, 1), seed=7)
    jl, jkv = jax.jit(lambda p, b, c: jregistry.serve_fn(cfg_j)(p, b, c))(
        params, {"tokens": jnp.asarray(tok)},
        {k: jnp.asarray(a) for k, a in cache.items()})
    with torch.no_grad():
        tl, tkv = registry.serve_fn(cfg)(
            model, {"tokens": torch.from_numpy(tok)},
            {k: torch.from_numpy(a) for k, a in cache.items()})
    assert tl.shape == (B, 1, cfg.padded_vocab)
    assert _rel(tl.numpy(), jl) <= MODEL_REL
    for t, j in zip(tkv, jkv):
        assert t.shape == (L, B, 1, cfg.n_kv_heads, cfg.hd) == j.shape
        assert _rel(t.numpy(), j) <= MODEL_REL


def test_decode_chain_matches_teacher_forced_forward(one_device_mesh):
    """f32: a prompt of 6 tokens (its self K / V from the decoder's layers
    and the cross K / V from ``encode``, as chip_smoke.py builds them),
    then 8 greedy ``serve_fn`` steps, each
    appending its new K / V: the tokens are the argmax of the
    teacher-forced forward over prompt and output, and each step's logits
    within MODEL_REL of that forward's at its position; the chain's first
    logits also the prompt's last in the reference's forward."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    model = _model(cfg, params)
    P, G = 6, 8
    prompt = torch.from_numpy(_tokens(cfg, (2, P), seed=9))
    frames = torch.from_numpy(_frames(cfg, 2, seed=10))
    serve = registry.serve_fn(cfg)
    with torch.no_grad():
        (ck, cv), memory = _cross_kv(cfg, model, frames)
        k, v = _self_cache(cfg, model, prompt[:, :-1], memory)
        tok, out, logits = prompt[:, -1:], [], []
        for _ in range(G):
            lg, (nk, nv) = serve(model, {"tokens": tok},
                                 {"k": k, "v": v, "cross_k": ck,
                                  "cross_v": cv})
            k, v = torch.cat([k, nk], 2), torch.cat([v, nv], 2)
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok)
            logits.append(lg)
        out, logits = torch.cat(out, 1), torch.cat(logits, 1)
        full = torch.cat([prompt, out[:, :-1]], 1)
        forced = registry.logits_fn(cfg, model, {"tokens": full,
                                                 "frames": frames})[:, P - 1:]
    np.testing.assert_array_equal(out.numpy(), forced.argmax(-1).numpy())
    assert _rel(logits.numpy(), forced.numpy()) <= MODEL_REL
    want = jax.jit(lambda p, t, f: jwhisper.forward(cfg_j, p, t, f))(
        params, jnp.asarray(prompt.numpy()), jnp.asarray(frames.numpy()))
    assert _rel(logits[:, :1].numpy(), np.asarray(want)[:, -1:]) <= MODEL_REL


def test_bf16_head_dim_64_within_twice_the_reference(one_device_mesh):
    """bf16 at whisper-small's head dim 64 (d 128, 2 heads; kv_chunk 8,
    the smoke config's, with 24 frames: three chunks) over T = 20: the
    port's logits no further from the reference's f32 logits than twice
    the reference's own bf16 forward (relative L2 and max)."""
    kw = dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
              encoder_len=24)
    cfg_j, cfg = _cfgs("bfloat16", **kw)
    assert cfg.hd == 64
    params = _params(cfg_j, seed=5)
    tokens = _tokens(cfg, (2, 20), seed=6)
    frames = _frames(cfg, 2, seed=7)
    fwd = jax.jit(lambda c, p, t, f: jwhisper.forward(c, p, t, f),
                  static_argnums=0)
    args = (params, jnp.asarray(tokens), jnp.asarray(frames))
    want = np.asarray(fwd(cfg_j.scaled(compute_dtype="float32"), *args))
    jbf = np.asarray(fwd(cfg_j, *args).astype(jnp.float32))
    with torch.no_grad():
        got = whisper.forward(cfg, _model(cfg, params),
                              torch.from_numpy(tokens),
                              torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()

    def l2(a):
        return np.linalg.norm(a - want) / np.linalg.norm(want)

    assert l2(got) <= 2 * l2(jbf)
    assert _rel(got, want) <= 2 * _rel(jbf, want)


# ---------------------------------------------------------------- train
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradient_match_reference(remat, one_device_mesh):
    """f32, batch 2 x 12 with 8 frames: ``registry.loss_fn``'s value
    within 1e-5 relative and every gradient leaf within 1e-4 max|g| of
    ``jax.value_and_grad``'s (``enc_pos`` and the encoder's leaves reach
    the loss through the cross-attention)."""
    cfg_j, cfg = _cfgs(remat=remat)
    params = _params(cfg_j)
    tokens, frames = _tokens(cfg, (2, 12), seed=8), _frames(cfg, 2, seed=9)
    jl, jg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))(
        params, {"tokens": jnp.asarray(tokens),
                 "frames": jnp.asarray(frames)})
    tl, tg = steps.value_and_grad(cfg, params_from_numpy(_np(params), "cpu"),
                                  {"tokens": torch.from_numpy(tokens),
                                   "frames": torch.from_numpy(frames)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    got = [x.detach().numpy() for x in tcomp._flatten(tg)[0]]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
    # embed, enc_pos, the 4 final-norm leaves, 18 decoder and 12 encoder
    # stacks
    assert len(got) == len(want) == 2 + 4 + 18 + 12
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(b).max() > 0
        assert _rel(a, b) <= 1e-4


def test_train_step_cuts_frames_with_tokens(capsys):
    """The train step's microbatches take the frames rows with their
    tokens; two steps of the smoke config with compressed gradients run
    on the CPU with finite losses, as the train launcher drives them."""
    batch = {"tokens": torch.arange(8).reshape(4, 2),
             "frames": torch.arange(4 * 3 * 2.0).reshape(4, 3, 2)}
    mbs = steps._split_microbatches(batch, 2)
    for i, mb in enumerate(mbs):
        assert torch.equal(mb["tokens"], batch["tokens"][2 * i:2 * i + 2])
        assert torch.equal(mb["frames"], batch["frames"][2 * i:2 * i + 2])
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--mechanism", "aggregate_gaussian",
                       "--no-per-coord", "--fused", "--grad-accum", "2"])
    losses = [float(line.split("loss ")[1].split()[0])
              for line in capsys.readouterr().out.splitlines()
              if " loss " in line]
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)


# ----------------------------------------------------------- structure
@pytest.mark.parametrize("key", [None, 3])
def test_frames_stub_bitwise(key):
    """``0.02 * normal(key, (B, encoder_len, d_model))`` with the default
    key PRNGKey(13): bit for bit the reference's, at the smoke and the full
    config's widths (1500 frames of 768)."""
    for get, jget in ((configs.get_smoke_config, jconfigs.get_smoke_config),
                      (configs.get_config, jconfigs.get_config)):
        cfg, cfg_j = get(ARCH), jget(ARCH)
        tokens = np.zeros((2, 3), np.int32)
        jk = None if key is None else jax.random.PRNGKey(key)
        tk = None if key is None else prng.PRNGKey(key)
        want = np.asarray(jsyn.with_frontend_stubs(
            {"tokens": jnp.asarray(tokens)}, cfg_j, jk)["frames"])
        got = tsyn.with_frontend_stubs({"tokens": torch.from_numpy(tokens)},
                                       cfg, tk)["frames"]
        assert got.dtype == torch.float32
        assert got.shape == (2, cfg.encoder_len, cfg.d_model)
        np.testing.assert_array_equal(got.numpy(), want)


def test_converter_init_and_refusals():
    """``whisper_from_numpy`` keeps the reference's tree under its names
    (one module per encoder and decoder layer, each leaf its stack's
    slice); ``init_model`` draws the reference's specs in the compute
    dtype; the serve engine and the naive loop refuse whisper, as the
    reference's do."""
    cfg_j, cfg = _cfgs()
    params = _np(_params(cfg_j))
    model = whisper_from_numpy(cfg, params, "cpu")
    assert len(model.enc_layers) == cfg.encoder_layers
    assert len(model.dec_layers) == cfg.n_layers
    for stack in whisper.STACKS:
        for i, lp in enumerate(getattr(model, stack)):
            for part in ("attn", "mlp") + (("cross",) if stack[0] == "d"
                                           else ()):
                for name, leaf in params[stack][part].items():
                    np.testing.assert_array_equal(
                        getattr(lp, part)[name].numpy(), leaf[i])
            np.testing.assert_array_equal(lp.norm1_b.numpy(),
                                          params[stack]["norm1_b"][i])
    for name in ("embed", "enc_pos", "enc_final_w", "final_b"):
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      params[name])
    gen = torch.Generator().manual_seed(0)
    bf = registry.init_model(cfg.scaled(compute_dtype="bfloat16"), gen, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    assert sum(p.numel() for p in bf.parameters()) == nn.spec_numel(
        registry.param_specs(cfg))
    with pytest.raises(NotImplementedError, match="frames"):
        ServeEngine(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="cross-KV"):
        naive_generate(cfg, model, {"tokens": torch.zeros((1, 2),
                                                          dtype=torch.int32)},
                       2)


def test_full_config_parameter_count():
    """whisper-small: 239,431,680 parameters in the specs, as in the
    reference's (the vocab padded to 51,968); 12 heads of 64."""
    cfg, cfg_j = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jregistry.param_specs(cfg_j),
        is_leaf=lambda x: isinstance(x, jnn.ParamSpec)))
    assert nn.spec_numel(registry.param_specs(cfg)) == want == 239_431_680
    assert cfg.hd == 64 and cfg.padded_vocab == 51_968


# ------------------------------------------------------ flash attention
def _qkv(B, T, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), dtype=np.float32),
            rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, S, H, D), dtype=np.float32))


def _jax_attn(q, k, v, q_chunk):
    return np.array(jattn.flash_attention(
        q, k, v, causal=False, q_chunk=q_chunk, kv_chunk=1024).astype(
            jnp.float32))


# (B, T, S): the decode step's one query, the decoder's cross-attention
# (T < S) and the encoder's self-attention, S past one 1024-key chunk
MASK_CASES = [(2, 1, 1100), (1, 40, 1100), (1, 1030, 1030)]


@pytest.mark.parametrize("B,T,S", MASK_CASES)
def test_plain_flash_at_whisper_masks(B, T, S):
    """Non-causal at whisper's shapes, heads of 64: the plain f32 forward
    within 2e-5 of the JAX model's ``flash_attention(causal=False)``; bf16
    at kv_chunk 1024 (P rounded against the same running max: one chunk of
    1024 keys, then a ragged one) every output within one ulp + 2^-9 max|v|
    and 99% within one ulp + 2e-5 of the JAX model's bf16."""
    q, k, v = _qkv(B, T, S, 2, 64, seed=T)
    q_chunk = 1 if T == 1 else 256
    want = _jax_attn(*map(jnp.asarray, (q, k, v)), q_chunk)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False, kv_tile=1024)
    assert float(np.abs(got.numpy() - want).max()) <= ATOL
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = torch.from_numpy(_jax_attn(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb),
        q_chunk))
    got = ops.flash_attention(*tb, causal=False, kv_tile=1024)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 2, 64)
    diff = (got.float() - want).abs()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    assert int((diff > ulp + BF16_P_BAR * float(tb[2].float().abs().max()))
               .sum()) == 0
    assert float((diff <= ulp + ATOL).float().mean()) >= BF16_SHARE


def test_plain_flash_backward_non_causal_t_below_s():
    """f32 non-causal with T < S (the decoder's cross-attention): the
    gradient through ``ops.flash_attention`` (the plain backward on the
    CPU) within 2e-5 max|g| of ``jax.vjp`` of the JAX model's attention."""
    q, k, v = _qkv(1, 40, 1100, 2, 64, seed=11)
    do = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)

    def fn(q, k, v):
        return jattn.flash_attention(q, k, v, causal=False, q_chunk=256,
                                     kv_chunk=1024)

    want = jax.jit(lambda *a: jax.vjp(fn, *a[:3])[1](a[3]))(
        *map(jnp.asarray, (q, k, v, do)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ops.flash_attention(*xs, causal=False, kv_tile=1024).backward(
        torch.from_numpy(do))
    for x, w in zip(xs, want):
        w = np.asarray(w)
        assert float(np.abs(x.grad.numpy() - w).max()) <= 2e-5 * np.abs(
            w).max()
