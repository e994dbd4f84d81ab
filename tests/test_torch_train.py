"""The port's train step against the JAX package's (``repro.train.steps``),
with the JAX package's parameters carried across as numpy arrays and its
models on a one-device mesh (on the multi-device default mesh they raise
under jax 0.9):

  * loss and gradients of the qwen1.5 smoke config in f32, without and
    with gradient accumulation;
  * the post-gradient half of the step (the n = 1 compressed aggregation
    and AdamW) fed the JAX package's gradients;
  * three whole steps against ``jax.jit(build_train_step)`` on a mesh
    without a ``pod`` axis;
  * bf16 at head_dim 128, against the JAX model's own bf16 error;
  * the step across 2 client ranks (gloo, tests/torch_ranks.py) against
    the reference assembled from its parts as its ``build_train_step``
    does: per-client ``value_and_grad``, ``compress_tree(axis="pod")`` in
    a jitted shard_map over 2 CPU devices, AdamW;
  * checkpoint-and-resume, both packages' formats;
  * ``ModelGradWorkload`` and the async runtime with it;
  * the train CLI."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.dist import compress as jcomp
from repro.dist import meshctx
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.runtime import workloads as jworkloads
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.checkpoint import checkpoint
from repro_torch.convert import params_from_numpy
from repro_torch.dist import compress as tcomp
from repro_torch.fl.federated import FederatedAveraging, FLConfig
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.runtime import (AsyncFederatedRuntime, ModelGradWorkload,
                                 RuntimeConfig)
from repro_torch.train import steps

ARCH = "qwen1.5-0.5b"
LR = 3e-4
# f32 bars: the loss within 1e-5 relative, each gradient leaf within
# 1e-4 max|g| (measured: loss 8.6e-8 relative, leaves 5.6e-7-1.4e-6
# max|g|, from the summation orders of the matmuls and the attention)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors, as the other
    process-group test files: the test workers share the machine's cores
    with the reference's wall-clock tests."""
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


def _cfgs(arch=ARCH, **kw):
    cfg_j = jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32",
                                                   **kw)
    cfg = configs.get_smoke_config(arch).scaled(compute_dtype="float32",
                                                **kw)
    return cfg_j, cfg


def _params(cfg_j, seed=0):
    """The reference's parameter tree with its init law, drawn with numpy
    from ``seed`` (the reference's ``init_params`` folds ``hash()`` of
    each path's names into its keys, so its weights change from one
    process to the next)."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if spec.init in ("zeros", "ones"):
            x = np.full(spec.shape, 1.0 if spec.init == "ones" else 0.0)
        elif spec.init == "embed" or len(spec.shape) < 2:
            x = spec.scale * 0.02 * rng.standard_normal(spec.shape)
        else:
            x = (spec.scale / np.sqrt(max(spec.shape[-2], 1))
                 * rng.standard_normal(spec.shape))
        return jnp.asarray(x.astype(np.float32))

    return jax.tree.map(make, jregistry.param_specs(cfg_j),
                        is_leaf=lambda x: isinstance(x, jnn.ParamSpec))


def _tokens(cfg, shape=(4, 32), seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape,
                                                dtype=np.int32)


def _tleaves(tree):
    return [x.numpy() for x in tcomp._flatten(tree)[0]]


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _state(params_np, opt="adamw"):
    p = params_from_numpy(params_np, "cpu")
    return {"params": p, "opt_state": get_optimizer(opt, LR).init(p),
            "step": torch.zeros((), dtype=torch.int32)}


# ------------------------------------------------------ loss and gradient
@pytest.mark.parametrize("accum", [1, 2])
def test_loss_and_gradients_match_reference(accum, one_device_mesh):
    """f32 smoke config, batch 4 x seq 32: the loss within 1e-5 relative
    and every one of the 14 gradient leaves within 1e-4 max|g| of
    ``jax.value_and_grad(registry.loss_fn(cfg))`` (with ``grad_accum`` 2
    against the reference step's microbatch sum)."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    tokens = _tokens(cfg)
    vg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))
    if accum == 1:
        jl, jg = vg(params, {"tokens": jnp.asarray(tokens)})
    else:
        parts = [vg(params, {"tokens": jnp.asarray(t)})
                 for t in np.split(tokens, accum)]
        jl = sum(float(l) for l, _ in parts) / accum
        jg = jax.tree.map(lambda *g: sum(g) / accum, *(g for _, g in parts))
    tc = steps.TrainConfig(grad_accum=accum)
    tl, tg = steps.loss_and_grads(cfg, tc, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"),
        {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    got, want = _tleaves(tg), _jleaves(jg)
    assert len(got) == len(want) == 14
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        assert _max_rel(a, b) <= GRAD_REL


# -------------------------------------------------- post-gradient half
POST_CASES = [
    ("aggregate_gaussian", dict(mechanism="aggregate_gaussian", sigma=1e-3,
                                fused=True, msg_bits=8, per_coord=False)),
    ("layered_shifted", dict(mechanism="layered_shifted", sigma=1e-3)),
]


def _recording(mp, module, quantizer):
    """Record every message ``module``'s compress_tree encodes: the
    homomorphic ``encode_leaf`` and the layered quantizer's ``encode``."""
    seen = []

    def wrap(fn):
        def rec(*args, **kw):
            seen.append(fn(*args, **kw))
            return seen[-1]
        return rec

    mp.setattr(module, "encode_leaf", wrap(module.encode_leaf))
    mp.setattr(quantizer, "encode", wrap(quantizer.encode))
    return seen


@pytest.mark.parametrize("name,kw", POST_CASES)
def test_compressed_update_with_reference_gradients(name, kw,
                                                    one_device_mesh,
                                                    monkeypatch):
    """The n = 1 step after the gradient, fed the JAX package's
    gradients: ``compress_tree(axis=None)`` under ``fold_in(PRNGKey(seed),
    step)`` (aggregate_gaussian fused b = 8 with per-tensor randomness,
    as the chip's train phase runs it; layered_shifted), then AdamW.
    The messages of all 14 leaves are bitwise the jitted reference's; the
    decoded gradient is within 1.2e-7 absolute (1-2 ulp: XLA rounds the
    decode's multiply-add once or twice by jit context, ROADMAP Queue 3
    item 2; measured 0-3.7e-9 here); and AdamW's ``apply`` on the
    reference's decoded gradient is bitwise the reference's jitted
    update-and-add (the optimizer bar of tests/test_torch_optim.py)."""
    from repro.core import layered as jlayered
    from repro_torch.core import layered as tlayered

    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    _, grads = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))(
        params, {"tokens": jnp.asarray(_tokens(cfg))})
    jc = jcomp.CompressionConfig(**kw)
    seed, step = 5, 0

    jseen = _recording(monkeypatch, jcomp, jlayered.LayeredQuantizer)

    @jax.jit
    def compress(g):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        out = jcomp.compress_tree(g, jc, key, axis=None, n_clients=1)
        return out, list(jseen)

    jg, jmsgs = compress(grads)
    tseen = _recording(monkeypatch, tcomp, tlayered.LayeredQuantizer)
    tg = tcomp.compress_tree(
        params_from_numpy(jax.tree.map(np.asarray, grads), "cpu"),
        tcomp.CompressionConfig(**kw), tcomp.prng.fold_in(
            tcomp.prng.PRNGKey(seed), step), axis=None, n_clients=1,
        device="cpu")
    monkeypatch.undo()
    assert len(tseen) == len(jmsgs) == 14
    for a, b in zip(tseen, jmsgs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(_tleaves(tg), _jleaves(jg)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1.2e-7)

    opt = joptim.get_optimizer("adamw", LR)

    @jax.jit
    def apply(g, state, p):  # the state is an input, as in the train step
        upd, _ = opt.update(g, state, p)
        return jax.tree.map(jnp.add, p, upd)

    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    topt = get_optimizer("adamw", LR)
    new, _ = topt.apply(params_from_numpy(jax.tree.map(np.asarray, jg),
                                          "cpu"), topt.init(tp), tp)
    want = apply(jg, opt.init(params), params)
    for a, b in zip(_tleaves(new), _jleaves(want)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- whole steps
# AdamW moves a coordinate by at most B lr a step, B = (1 - b1) /
# (sqrt(1 - b2) (1 - b1 / sqrt(b2))) = 5.84 at (0.9, 0.95); a message
# that flips moves its coordinate's decoded gradient by one quantizer
# step and so its update by at most 2 B lr
ADAM_BOUND = (1 - 0.9) / (np.sqrt(1 - 0.95) * (1 - 0.9 / np.sqrt(0.95)))


def test_three_steps_match_the_jitted_reference(one_device_mesh):
    """Three steps of the launcher's configuration (AdamW, lr 3e-4,
    aggregate_gaussian fused b = 8 with per-tensor randomness, sigma 1e-3)
    against ``jax.jit(steps.build_train_step)`` on a (data, model) mesh:
    each loss within 1e-5 relative; every parameter within 3 x 2 B lr of
    the reference (B the AdamW bound above: what a flipped message, or a
    gradient near zero that differs in its last bits, can do to one
    coordinate a step), and at least 99.9% of them within 1e-6 relative
    + 1e-9 (the optimizer bar).  Measured: the params bitwise equal after
    three steps."""
    cfg_j, cfg = _cfgs()
    kw = dict(mechanism="aggregate_gaussian", sigma=1e-3, fused=True,
              msg_bits=8, per_coord=False)
    jtc = jsteps.TrainConfig(lr=LR, compression=jcomp.CompressionConfig(**kw))
    ttc = steps.TrainConfig(lr=LR, compression=tcomp.CompressionConfig(**kw))
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    params = _params(cfg_j)
    jstate = {"params": params,
              "opt_state": joptim.get_optimizer("adamw", LR).init(params),
              "step": jnp.zeros((), jnp.int32)}
    tstate = _state(jax.tree.map(np.asarray, params))
    jstep = jax.jit(jsteps.build_train_step(cfg_j, jtc, mesh))
    tstep = steps.build_train_step(cfg, ttc)
    for i in range(3):
        tokens = _tokens(cfg, seed=10 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)},
                           jnp.int32(5))
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)}, 5)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
            LOSS_RTOL * abs(float(jm["loss"])))
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    diffs = [np.abs(a - b) for a, b in zip(_tleaves(tstate["params"]),
                                           _jleaves(jstate["params"]))]
    assert max(float(d.max()) for d in diffs) <= 3 * 2 * ADAM_BOUND * LR
    _assert_mostly_within_optimizer_bar(tstate["params"], jstate["params"])


def _assert_mostly_within_optimizer_bar(got, want, share=0.999):
    """At least ``share`` of all parameters within 1e-6 relative + 1e-9."""
    n = bad = 0
    for a, b in zip(_tleaves(got) if isinstance(got, dict) else got,
                    _jleaves(want) if isinstance(want, dict) else want):
        bad += int((np.abs(a - b) > 1e-6 * np.abs(b) + 1e-9).sum())
        n += a.size
    assert bad <= (1 - share) * n, (bad, n)


# ------------------------------------------------------------------ bf16
def test_bf16_head_dim_128_step_error_at_most_twice_the_jax_models(
        one_device_mesh):
    """qwen3-32b's smoke depth and widths with head_dim 128 in bf16 (the
    test_bf16_head_dim_128_matches_reference shape): every gradient leaf,
    the port's and the JAX model's bf16 ones each against the JAX model's
    f32 gradient of the same params, the port's relative L2 error at most
    twice the JAX model's (measured 0.78-1.02 of it, whose own errors
    are 9.7e-3-2.4e-2).  The loss is one scalar: its bf16 error is a
    handful of roundings, 0.7-4 times the JAX model's across the
    parameter draws tried, so it is held within one bf16 rounding (2^-8
    relative) of the JAX model's bf16 loss and of the f32 loss instead
    (measured 1.4e-4 relative to the bf16 loss)."""
    cfg_j = jconfigs.get_smoke_config("qwen3-32b").scaled(head_dim=128)
    cfg = configs.get_smoke_config("qwen3-32b").scaled(head_dim=128)
    assert cfg.compute_dtype == "bfloat16"
    params = _params(cfg_j)
    tokens = _tokens(cfg, shape=(2, 24), seed=5)

    def jvg(c):
        f = jax.jit(jax.value_and_grad(lambda p, b: jregistry.loss_fn(c)(
            jnn.cast_tree(p, jnp.dtype(c.compute_dtype)), b)))
        loss, g = f(params, {"tokens": jnp.asarray(tokens)})
        return float(loss), _jleaves(g)

    l32, g32 = jvg(cfg_j.scaled(compute_dtype="float32"))
    lbf, gbf = jvg(cfg_j)
    lp, gp = steps.value_and_grad(
        cfg, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        {"tokens": torch.from_numpy(tokens)})
    assert abs(float(lp) - lbf) <= 2.0 ** -8 * abs(lbf)
    assert abs(float(lp) - l32) <= 2.0 ** -8 * abs(l32)
    for a, b, c in zip(_tleaves(gp), gbf, g32):
        port = np.linalg.norm(a - c) / np.linalg.norm(c)
        assert port <= 2 * np.linalg.norm(b - c) / np.linalg.norm(c)


# ----------------------------------------------------------- client path
N_RANKS = 2
RANK_COMP = dict(mechanism="aggregate_gaussian", sigma=1e-3, fused=True,
                 msg_bits=8, per_coord=False)
RANK_SEED = 5


def test_client_ranks_step(one_device_mesh):
    """2 gloo ranks, each a client with its half of a global batch of 4.
    The reference is built from its parts, as its build_train_step does:
    per-client ``jax.value_and_grad`` on each client's slice, then
    ``compress_tree(axis="pod")`` in a jitted shard_map over 2 CPU
    devices, then AdamW.  Fed the reference's per-client gradients, the
    ranks' summed words (aggregate_gaussian fused b = 8, per-tensor
    randomness) are bitwise the reference's psum; the decoded aggregate
    is within 1e-6 of it (the fused decode's bar: inside the shard_map XLA
    rounds the decode's step / n differently, up to an ulp, as
    tests/test_torch_dist.py states); the params after AdamW are bitwise
    equal on both ranks and within the optimizer bar (1e-6 relative +
    1e-9) of the reference's.  Then one whole step on the ranks, from
    their own gradients: both ranks bitwise equal, the loss within 1e-5
    relative of the mean of the reference's client losses, every param
    within 2 B lr of the reference's (what a flipped message or a
    near-zero gradient's last bits can do through AdamW) and at least
    99.9% within the optimizer bar (measured: all 99,008 within it; with
    another parameter draw 1 of 99,008 was outside it, by 3.2e-8)."""
    cfg_j, cfg = _cfgs()
    params = _params(cfg_j)
    tokens = _tokens(cfg)
    vg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))
    parts = [vg(params, {"tokens": jnp.asarray(t)})
             for t in np.split(tokens, N_RANKS)]
    losses = [float(l) for l, _ in parts]
    stacked = jax.tree.map(lambda *g: jnp.stack(g), *(g for _, g in parts))
    mesh = jax.make_mesh((N_RANKS, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:N_RANKS])
    comp = jcomp.CompressionConfig(**RANK_COMP)
    key = jax.random.fold_in(jax.random.PRNGKey(RANK_SEED), 0)
    words = []

    def psum(m, comp, axis, _psum=jcomp._psum_msg):
        words.append(_psum(m, comp, axis))
        return words[-1]

    def aggregate(g):
        local = jax.tree.map(lambda t: t[0], g)
        out = jcomp.compress_tree(local, comp, key, axis="pod",
                                  n_clients=N_RANKS)
        return out, list(words)

    mp = pytest.MonkeyPatch()
    mp.setattr(jcomp, "_psum_msg", psum)
    try:
        agg, want_words = jax.jit(jax.shard_map(
            aggregate, mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P("pod"), stacked),),
            out_specs=(jax.tree.map(lambda _: P(), params),
                       [P()] * 14), check_vma=False))(stacked)
    finally:
        mp.undo()
    opt = joptim.get_optimizer("adamw", LR)

    @jax.jit
    def apply(g, state, p):  # the state is an input, as in the train step
        u, _ = opt.update(g, state, p)
        return jax.tree.map(jnp.add, p, u)

    want_params = _jleaves(apply(agg, opt.init(params), params))
    out = torch_ranks.run_ranks(
        torch_ranks.train_client_step, N_RANKS, ARCH,
        jax.tree.map(np.asarray, params), [_jleaves(g) for _, g in parts],
        tokens, RANK_COMP, RANK_SEED)
    for r in out:
        assert len(r["words"]) == 14
        for a, b in zip(r["words"], want_words):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(r["aggregate"], _jleaves(agg)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b, c in zip(r["params"], out[0]["params"], want_params):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-9)
        assert r["cohort"] == N_RANKS
        assert abs(r["step_loss"] - np.mean(losses)) <= (
            LOSS_RTOL * np.mean(losses))
        for a, b, c in zip(r["step_params"], out[0]["step_params"],
                           want_params):
            np.testing.assert_array_equal(a, b)
            assert float(np.abs(a - c).max()) <= 2 * ADAM_BOUND * LR
        _assert_mostly_within_optimizer_bar(r["step_params"], want_params)


# ----------------------------------------------------- checkpoint, resume
def test_checkpoint_resume_bitwise_and_both_formats(tmp_path,
                                                    one_device_mesh):
    """Three steps without a break equal one step, a checkpoint, a
    restore and two more, bitwise (compressed n = 1 steps: the key is the
    state's step); the checkpoint restores in the JAX package
    (``checkpoint.restore`` into its abstract train state) with every
    leaf equal, and a JAX-written train state restores in the port."""
    cfg_j, cfg = _cfgs()
    kw = dict(mechanism="aggregate_gaussian", sigma=1e-3, fused=True,
              msg_bits=8, per_coord=False)
    tc = steps.TrainConfig(lr=LR, compression=tcomp.CompressionConfig(**kw))
    step = steps.build_train_step(cfg, tc)
    dc_tokens = [_tokens(cfg, seed=20 + i) for i in range(3)]
    s0 = _state(jax.tree.map(np.asarray, _params(cfg_j)))

    def run(state, lo, hi):
        for i in range(lo, hi):
            state, _ = step(state, {"tokens": torch.from_numpy(
                dc_tokens[i])}, 5)
        return state

    straight = run(s0, 0, 3)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, run(s0, 0, 1))
    resumed, at = steps.restore_train_state(d, cfg, tc, device="cpu")
    assert at == 1 and int(resumed["step"]) == 1
    resumed = run(resumed, 1, 3)
    for a, b in zip(_tleaves(straight), _tleaves(resumed)):
        np.testing.assert_array_equal(a, b)

    jtc = jsteps.TrainConfig(lr=LR)
    jstate = jckpt.restore(d, 1, jsteps.make_train_state_specs(cfg_j, jtc))
    on_disk = steps.restore_train_state(d, cfg, tc, step=1, device="cpu")[0]
    for a, b in zip(_tleaves(on_disk), _jleaves(jstate)):
        np.testing.assert_array_equal(a, b)
    d2 = str(tmp_path / "jax")
    jckpt.save(d2, 7, jstate)
    back, at = steps.restore_train_state(d2, cfg, tc, device="cpu")
    assert at == 7
    for a, b in zip(_tleaves(back), _jleaves(jstate)):
        np.testing.assert_array_equal(a, b)
    assert back["opt_state"][2].dtype == torch.int32


# ------------------------------------------------------------- workload
def test_model_grad_workload_matches_reference(one_device_mesh):
    """``grad(flat, c, r)`` of the smoke config against the JAX package's
    workload on the JAX package's flat parameter vector (the port's
    ``init_params`` uses its own init): the flat gradient within 1e-4
    max|g|, f32 numpy, of the same length."""
    jwl = jworkloads.ModelGradWorkload(arch=ARCH, seq=32, batch=2)
    wl = ModelGradWorkload(arch=ARCH, seq=32, batch=2, device="cpu")
    flat = jwl.init_params()
    assert wl.init_params().shape == flat.shape
    jgrad, tgrad = jwl.build(), wl.build()
    for c, r in ((0, 0), (2, 3)):
        want = jgrad(flat, c, r)
        got = tgrad(flat, c, r)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert _max_rel(got, want) <= GRAD_REL


def test_async_runtime_with_model_workload_equals_sync():
    """The async runtime at staleness 0 with the model workload reproduces
    the synchronous loop bitwise (3 clients, 2 rounds, per-tensor
    aggregate_gaussian)."""
    fl = FLConfig(n_clients=3, mechanism="aggregate_gaussian", sigma=1e-3,
                  lr=0.1, seed=0, mech_kwargs=(("per_coord", False),))
    wl = ModelGradWorkload(arch=ARCH, seq=16, batch=2, device="cpu")
    grad = wl.build()
    fa = FederatedAveraging(
        fl, lambda p, c, r: torch.from_numpy(grad(p, c, r)), device="cpu")
    p_sync = torch.from_numpy(wl.init_params())
    for rnd in range(2):
        p_sync, _ = fa.round(p_sync, rnd)
    rt = AsyncFederatedRuntime(RuntimeConfig(fl=fl, staleness_bound=0,
                                             transport="thread",
                                             round_timeout_s=60.0), wl,
                               device="cpu")
    p_async, summary, _ = rt.run(wl.init_params(), 2)
    assert summary["rounds"] == 2
    np.testing.assert_array_equal(p_sync.numpy(), p_async)


# ------------------------------------------------------------------ CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", ARCH, "--smoke", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_train_cli_on_the_cpu_and_cuda_by_default():
    """Three compressed steps on the CPU print the loss; without
    ``--device cpu`` the launcher asks for the card and raises here."""
    run = _cli("--device", "cpu", "--steps", "3", "--mechanism",
               "aggregate_gaussian", "--no-per-coord", "--fused")
    assert run.returncode == 0, run.stderr
    lines = [ln for ln in run.stdout.splitlines() if " loss " in ln]
    assert len(lines) == 2 and "tok/s" in lines[-1]
    assert np.isfinite(float(lines[-1].split(" loss ")[1].split()[0]))
    run = _cli("--steps", "1")
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_step_across_ranks_takes_a_process_group_and_compression():
    """The JAX package's mesh-axis name has no counterpart: the client
    path takes a ``torch.distributed`` process group (TypeError
    otherwise); the entry points default to CUDA and raise here."""
    _, cfg = _cfgs()
    tc = steps.TrainConfig(compression=tcomp.CompressionConfig(
        mechanism="irwin_hall", sigma=1e-3))
    with pytest.raises(TypeError, match="ProcessGroup"):
        steps.build_train_step(cfg, tc, group="pod")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.init_train_state(cfg, tc)


# ------------------------------------------------- the moe and llava kinds
KIND_ARCHS = ("phi3.5-moe-42b-a6.6b", "dbrx-132b", "llava-next-mistral-7b")


def _kind_cfgs(arch):
    kw = {"top_k": 4} if arch == "dbrx-132b" else {}
    return _cfgs(arch, **kw)


def _kind_batches(cfg_j, cfg, tokens):
    """The reference's and the port's batch: tokens, and for llava the
    patch stub each package attaches."""
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn

    return (jsyn.with_frontend_stubs({"tokens": jnp.asarray(tokens)}, cfg_j),
            tsyn.with_frontend_stubs({"tokens": torch.from_numpy(tokens)},
                                     cfg))


@pytest.mark.parametrize("arch", KIND_ARCHS)
def test_kind_loss_and_gradients_match_reference(arch, one_device_mesh):
    """moe (phi3.5-moe's smoke, dbrx's at top 4) and llava (with its patch
    stub), f32, batch 4 x 32 in 2 microbatches: the loss within 1e-5
    relative and every gradient leaf (the router, experts and
    ``patch_proj`` among them) within 1e-4 max|g| of the jitted
    reference's microbatch sum."""
    cfg_j, cfg = _kind_cfgs(arch)
    params = _params(cfg_j)
    tokens = _tokens(cfg)
    jb, tb = _kind_batches(cfg_j, cfg, tokens)
    vg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))
    parts = [vg(params, {k: v[i:i + 2] for k, v in jb.items()})
             for i in (0, 2)]
    jl = sum(float(l) for l, _ in parts) / 2
    jg = jax.tree.map(lambda *g: sum(g) / 2, *(g for _, g in parts))
    tl, tg = steps.loss_and_grads(
        cfg, steps.TrainConfig(grad_accum=2),
        params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), tb)
    assert abs(float(tl) - jl) <= LOSS_RTOL * abs(jl)
    got, want = _tleaves(tg), _jleaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _max_rel(a, b) <= GRAD_REL


@pytest.mark.parametrize("arch", KIND_ARCHS)
def test_kind_step_matches_the_jitted_reference(arch, one_device_mesh):
    """One step of the launcher's configuration (AdamW, aggregate_gaussian
    fused b = 8 per-tensor) for each new kind against ``jax.jit(steps.
    build_train_step)``, as the dense test above: the loss within 1e-5
    relative, every parameter within 2 B lr and 99.9% within the
    optimizer bar."""
    cfg_j, cfg = _kind_cfgs(arch)
    kw = dict(mechanism="aggregate_gaussian", sigma=1e-3, fused=True,
              msg_bits=8, per_coord=False)
    jtc = jsteps.TrainConfig(lr=LR, compression=jcomp.CompressionConfig(**kw))
    ttc = steps.TrainConfig(lr=LR, compression=tcomp.CompressionConfig(**kw))
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    params = _params(cfg_j)
    jstate = {"params": params,
              "opt_state": joptim.get_optimizer("adamw", LR).init(params),
              "step": jnp.zeros((), jnp.int32)}
    tstate = _state(jax.tree.map(np.asarray, params))
    jb, tb = _kind_batches(cfg_j, cfg, _tokens(cfg, seed=21))
    jstate, jm = jax.jit(jsteps.build_train_step(cfg_j, jtc, mesh))(
        jstate, jb, jnp.int32(5))
    tstate, tm = steps.build_train_step(cfg, ttc)(tstate, tb, 5)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= (
        LOSS_RTOL * abs(float(jm["loss"])))
    diffs = [np.abs(a - b) for a, b in zip(_tleaves(tstate["params"]),
                                           _jleaves(jstate["params"]))]
    assert max(float(d.max()) for d in diffs) <= 2 * ADAM_BOUND * LR
    _assert_mostly_within_optimizer_bar(tstate["params"], jstate["params"])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llava-next-mistral-7b"])
def test_kind_bf16_gradient_error_at_most_twice_the_jax_models(
        arch, one_device_mesh):
    """moe and llava in bf16 (smoke widths): each gradient leaf's relative
    L2 error against the JAX model's f32 gradient at most twice the JAX
    bf16 model's own (routing may flip on near ties in both); the loss
    within one bf16 rounding of both."""
    cfg_j, cfg = _kind_cfgs(arch)
    cfg_j, cfg = (c.scaled(compute_dtype="bfloat16") for c in (cfg_j, cfg))
    params = _params(cfg_j)
    tokens = _tokens(cfg, shape=(2, 24), seed=5)
    jb, tb = _kind_batches(cfg_j, cfg, tokens)

    def jvg(c):
        f = jax.jit(jax.value_and_grad(lambda p, b: jregistry.loss_fn(c)(
            jnn.cast_tree(p, jnp.dtype(c.compute_dtype)), b)))
        loss, g = f(params, jb)
        return float(loss), _jleaves(g)

    l32, g32 = jvg(cfg_j.scaled(compute_dtype="float32"))
    lbf, gbf = jvg(cfg_j)
    lp, gp = steps.value_and_grad(
        cfg, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), tb)
    assert abs(float(lp) - lbf) <= 2.0 ** -8 * abs(lbf)
    assert abs(float(lp) - l32) <= 2.0 ** -8 * abs(l32)
    for a, b, c in zip(_tleaves(gp), gbf, g32):
        port = np.linalg.norm(a - c) / np.linalg.norm(c)
        assert port <= 2 * np.linalg.norm(b - c) / np.linalg.norm(c)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llava-next-mistral-7b"])
def test_train_cli_runs_the_new_kinds(arch):
    """The train launcher's smoke mode on the CPU for moe and for llava
    (whose batches carry the patch stub)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "2", "--mechanism",
         "aggregate_gaussian", "--no-per-coord", "--fused"],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    lines = [ln for ln in run.stdout.splitlines() if " loss " in ln]
    assert len(lines) == 2
    assert np.isfinite(float(lines[-1].split(" loss ")[1].split()[0]))
