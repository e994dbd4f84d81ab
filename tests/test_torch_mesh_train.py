"""Training and checkpoints on the port's (pod, data, model) mesh over
gloo ranks on the CPU (tests/torch_mesh_ranks.py holds the rank sides),
against the JAX package, the port on one rank and the one-process codec:

  * (1, 2, 2), FSDP + TP, uncompressed: loss within 1e-6 relative and
    every gathered gradient leaf within 1e-4 max|g| of the one-rank
    step's and of the reference's ``value_and_grad`` of its loss, with
    and without gather_once, and one step's params;
  * (2, 1, 2), aggregate_gaussian fused b = 8: each pod's whole-leaf
    gradient within 1e-4 max|g| of the reference's on the pod's rows; the
    summed words equal the one-process codec's on the two pods'
    gradients, bitwise, and the reference's own compressed step's on a
    (2, 1, 2) host mesh (its loss within 1e-6
    relative, its summed words bitwise but for a word where the two
    gradients straddle a rounding boundary: at most WORD_FLIPS of them;
    measured none); the parameters bitwise equal across pods for each
    model rank after two steps, the cohort 2;
  * checkpoints: saved on (2, 1, 2), restored onto (1, 2, 2) and onto one
    rank, the gathered leaves bitwise equal to the saved ones.

qwen1.5-0.5b's smoke config in f32, its constant leaves drawn away from 0
and 1 (``test_torch_mesh._params``), one torch thread per rank."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_mesh_ranks as mr
import torch_ranks
from repro.dist import compress as jc
from repro.dist import meshctx as jmeshctx
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.train import steps as jsteps
from repro_torch.core import dither, prng
from repro_torch.dist import compress as dcompress
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.train import steps
from test_torch_mesh import _cfgs, _params

LOSS_REL = 1e-6
GRAD_REL = 1e-4
FUSED = dict(mechanism="aggregate_gaussian", sigma=1e-3, fused=True,
             msg_bits=8)
WORD_FLIPS = 1e-3
POD_SEED, POD_STEPS = 9, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRAIN_ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg_j, cfg = _cfgs(TRAIN_ARCH)
    params = _params(cfg_j, seed=1)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(4, 16),
                                               dtype=np.int32)
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    out = {"cfg": cfg, "params": params, "tokens": tokens, "ckpt": ckpt}
    out["fsdp"] = torch_ranks.run_ranks(
        mr.train_side, 4, (1, 2, 2), TRAIN_ARCH, params, tokens, None, 2,
        False, 1, 0, None, "sgd")
    out["fsdp_once"] = torch_ranks.run_ranks(
        mr.train_side, 4, (1, 2, 2), TRAIN_ARCH, params, tokens, None, 2,
        True, 1, 0, None, "sgd")
    out["pods"] = torch_ranks.run_ranks(
        mr.train_side, 4, (2, 1, 2), TRAIN_ARCH, params, tokens, FUSED, 1,
        False, POD_STEPS, POD_SEED, ckpt)
    out["restored"] = torch_ranks.run_ranks(
        mr.restore_side, 4, (1, 2, 2), TRAIN_ARCH, None, ckpt)
    # the one-rank port
    p = mr._tree(params)
    tc = steps.TrainConfig(optimizer="sgd", lr=3e-3, grad_accum=2)
    loss, g = steps.loss_and_grads(cfg, tc, p,
                                   {"tokens": torch.from_numpy(tokens)})
    out["one_loss"], out["one_grads"] = float(loss), [
        x.numpy() for x in mr._leaves(g)]
    state = {"params": p, "opt_state": get_optimizer("sgd", 3e-3).init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    state, _ = steps.build_train_step(cfg, tc)(
        state, {"tokens": torch.from_numpy(tokens)}, 0)
    out["one_params"] = [x.numpy() for x in mr._leaves(state["params"])]
    return out


def _on_mesh(mesh, fn):
    """``fn()`` with the reference's mesh set to ``mesh``."""
    prev = jmeshctx._mesh
    jmeshctx._mesh = mesh
    try:
        return fn()
    finally:
        jmeshctx._mesh = prev


def _one_device():
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])


def _ref_loss_and_grads(vg, params, tokens, accum):
    """The reference's loss and gradient leaves on ``tokens`` from ``vg``,
    its jitted ``value_and_grad`` of ``registry.loss_fn``, on a one-device
    mesh: the microbatches' mean as its step takes it."""
    p = jax.tree.map(jnp.asarray, params)
    parts = _on_mesh(_one_device(), lambda: [
        vg(p, {"tokens": jnp.asarray(t)}) for t in np.split(tokens, accum)])
    loss = sum(float(l) for l, _ in parts) / accum
    grads = jax.tree.map(lambda *g: sum(g) / accum, *(g for _, g in parts))
    return loss, [np.asarray(x) for x in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def reference(trained):
    """The reference on the fixture's params and tokens: the (1, 2, 2)
    step's loss and gradient (grad_accum 2), each pod's gradient at the
    first step, and its own compressed step on a (2, 1, 2) host mesh run
    POD_STEPS times (losses, cohort, and each step's summed words, read
    on every device by a debug callback)."""
    cfg_j = _cfgs(TRAIN_ARCH)[0]
    params, tokens = trained["params"], trained["tokens"]
    vg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))
    out = {"fsdp": _ref_loss_and_grads(vg, params, tokens, 2)}
    out["pod_grads"] = [_ref_loss_and_grads(vg, params, t, 1)[1]
                        for t in np.split(tokens, 2)]
    mesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(AxisType.Auto,) * 3)
    seen = {}

    def psum(m, comp, axis, _psum=jc._psum_msg):
        w = _psum(m, comp, axis)
        i = len(seen)
        seen[i] = []
        jax.debug.callback(lambda x, i=i: seen[i].append(np.asarray(x)), w)
        return w

    tc = jsteps.TrainConfig(optimizer="adamw", lr=3e-3,
                            compression=jc.CompressionConfig(**FUSED))
    p = jax.tree.map(jnp.asarray, params)
    state = {"params": p, "opt_state": joptim.get_optimizer(
        "adamw", 3e-3).init(p), "step": jnp.zeros((), jnp.int32)}
    # placed by the reference's rules, in and out: one trace
    sh = jsteps.train_state_shardings(cfg_j, tc, mesh)
    state = jax.device_put(jax.tree.map(
        lambda x: jnp.array(x, dtype=x.dtype), state), sh)
    mp = pytest.MonkeyPatch()
    mp.setattr(jc, "_psum_msg", psum)
    out["step_losses"], out["step_words"] = [], []
    try:
        step = jax.jit(jsteps.build_train_step(cfg_j, tc, mesh),
                       out_shardings=(sh, None))
        for _ in range(POD_STEPS):
            state, m = _on_mesh(mesh, lambda: step(
                state, {"tokens": jnp.asarray(tokens)}, POD_SEED))
            jax.effects_barrier()
            out["step_losses"].append(float(m["loss"]))
            out["cohort"] = int(m["cohort"])
            out["step_words"].append([list(v) for _, v in sorted(
                seen.items()) if v])
            for v in seen.values():
                v.clear()
    finally:
        mp.undo()
    return out


def _by_pod(ranks):
    by_pod = {}
    for g in ranks:
        by_pod.setdefault(g["coords"]["pod"], []).append(g)
    return by_pod


@pytest.mark.parametrize("variant", ["fsdp", "fsdp_once"])
def test_fsdp_tp_loss_and_gradient(trained, variant):
    """(1, 2, 2): the mean loss within 1e-6 relative and each gathered
    gradient leaf within 1e-4 max|g| of the one-rank step's; every rank
    gathers the same leaves."""
    ranks = trained[variant]
    one_loss = trained["one_loss"]
    for g in ranks:
        assert abs(g["loss"] - one_loss) <= LOSS_REL * abs(one_loss)
        for a, b in zip(g["grads"], ranks[0]["grads"]):
            np.testing.assert_array_equal(a, b)
    for got, want in zip(ranks[0]["grads"], trained["one_grads"]):
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= GRAD_REL * scale


@pytest.mark.parametrize("variant", ["fsdp", "fsdp_once"])
def test_fsdp_tp_loss_and_gradient_match_reference(trained, reference,
                                                   variant):
    """(1, 2, 2): the mean loss within 1e-6 relative and each gathered
    gradient leaf within 1e-4 max|g| of the reference's value_and_grad
    on the same params and tokens (grad_accum 2)."""
    ref_loss, ref_grads = reference["fsdp"]
    g = trained[variant][0]
    assert abs(g["loss"] - ref_loss) <= LOSS_REL * abs(ref_loss)
    assert len(g["grads"]) == len(ref_grads)
    for got, want in zip(g["grads"], ref_grads):
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= GRAD_REL * scale


def test_compressed_pods_match_the_reference(trained, reference):
    """(2, 1, 2), aggregate_gaussian fused b = 8: each pod's first-step
    gradient within 1e-4 max|g| of the reference's on its rows; at each
    step the summed words are, but for at most WORD_FLIPS of them, the
    reference's own compressed step's (on every device); the losses
    within 1e-6 relative; the cohort 2.  (The words are bitwise the
    port's one-process codec's on the pods' gradients, below, and that
    codec is bitwise the reference's in tests/test_torch_dist.py.)"""
    by_pod = _by_pod(trained["pods"])
    for c in (0, 1):
        for got, want in zip(by_pod[c][0]["records"][0]["grads"],
                             reference["pod_grads"][c]):
            assert got.shape == want.shape
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= GRAD_REL * scale
    assert reference["cohort"] == 2
    for s in range(POD_STEPS):
        ours = trained["pods"][0]["records"][s]["words"]
        ref_step = reference["step_words"][s]
        assert len(ref_step) == len(ours)
        differ = total = 0
        for i, b in enumerate(ours):
            assert len(ref_step[i]) == 4  # one read on each device
            for a in ref_step[i]:
                np.testing.assert_array_equal(a, ref_step[i][0])
            differ += int((ref_step[i][0] != b).sum())
            total += b.size
        assert differ <= WORD_FLIPS * total
        want = reference["step_losses"][s]
        for g in trained["pods"]:
            assert abs(g["losses"][s] - want) <= LOSS_REL * abs(want)


@pytest.mark.parametrize("variant", ["fsdp", "fsdp_once"])
def test_fsdp_tp_step_matches_one_rank(trained, variant):
    """One SGD step on (1, 2, 2) (an update linear in the gradient, so the
    gradient's bar carries over): the gathered params of every rank are
    the same bits, and each leaf within lr 1e-4 max|g| + 2^-23 max|p| of
    the one-rank step's."""
    ranks = trained[variant]
    assert len({g["digests"][0] for g in ranks}) == 1
    assert ranks[0]["cohort"] == 1
    for got, want, g in zip(ranks[0]["final"], trained["one_params"],
                            trained["one_grads"]):
        bar = 3e-3 * GRAD_REL * np.abs(g).max() + 2.0**-23 * np.abs(
            want).max()
        assert np.abs(got - want).max() <= bar


def test_compressed_pods_words_equal_the_one_process_codec(trained):
    """(2, 1, 2), aggregate_gaussian fused b = 8: at each step, each rank's
    summed words equal the sum over the two pods of the one-process
    codec's words on that pod's whole-leaf gradient (client index = pod),
    bitwise; every rank of a pod hands compress_tree the same gradient."""
    ranks = trained["pods"]
    comp = dcompress.CompressionConfig(**FUSED)
    by_pod = {}
    for g in ranks:
        by_pod.setdefault(g["coords"]["pod"], []).append(g)
    for pod, members in by_pod.items():
        for m in members:
            for a, b in zip(m["records"], members[0]["records"]):
                for x, y in zip(a["grads"], b["grads"]):
                    np.testing.assert_array_equal(x, y)
    for s in range(2):
        key = prng.fold_in(prng.PRNGKey(9), s)
        grads = [by_pod[c][0]["records"][s]["grads"] for c in (0, 1)]
        for i in range(len(grads[0])):
            kt, ks = prng.split(prng.fold_in(key, i))
            shape = grads[0][i].shape
            step, _, geom = dcompress._leaf_params(comp, 2, kt, shape, "cpu")
            total = None
            for c in (0, 1):
                x32 = torch.clamp(torch.from_numpy(grads[c][i]), -comp.clip,
                                  comp.clip)
                s_c = dither.dither_noise(prng.fold_in(ks, c), shape,
                                          device="cpu")
                w = dcompress.encode_leaf(x32, comp, step, s_c, geom)
                total = w if total is None else total + w
            for g in ranks:
                np.testing.assert_array_equal(g["records"][s]["words"][i],
                                              total.numpy())


def test_compressed_pods_params_bitwise_across_pods(trained):
    ranks = trained["pods"]
    by_model = {}
    for g in ranks:
        by_model.setdefault(g["coords"]["model"], []).append(g)
    for members in by_model.values():
        assert len(members) == 2
        assert members[0]["local_digest"] == members[1]["local_digest"]
    assert all(g["cohort"] == 2 for g in ranks)
    assert all(np.isfinite(x) for g in ranks for x in g["losses"])


def test_checkpoint_restores_onto_other_meshes(trained):
    """Saved on (2, 1, 2) (whole leaves gathered from the blocks), restored
    onto (1, 2, 2) (each rank cutting its blocks under PARAM_RULES, the
    target step uncompressed) and
    onto one rank: the gathered leaves bitwise equal to the saved ones."""
    cfg = trained["cfg"]
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-3,
                           compression=dcompress.CompressionConfig(**FUSED))
    one, step = steps.restore_train_state(trained["ckpt"], cfg, tc,
                                          device="cpu")
    assert step == 2
    one_leaves = [x.numpy() for x in mr._leaves(one)]
    saved = trained["pods"][0]["saved"]
    n_params = len(saved)
    # the state's leaves: opt m (n), opt v (n), count, params (n), step
    np.testing.assert_equal(len(one_leaves), 3 * n_params + 2)
    for a, b in zip(one_leaves[2 * n_params + 1:3 * n_params + 1], saved):
        np.testing.assert_array_equal(a, b)
    for r in trained["restored"]:
        assert r["step"] == 2
        for a, b in zip(r["whole"], one_leaves):
            np.testing.assert_array_equal(a, b)
    # (1, 2, 2) holds blocks: the embedding's rows over model, cols over data
    shapes = trained["restored"][0]["local_shapes"]
    assert (cfg.padded_vocab // 2, cfg.d_model // 2) in shapes
