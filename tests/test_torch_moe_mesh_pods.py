"""The moe kind's compressed step over pods on the port's mesh: (pod 2,
data 1, model 2) gloo ranks on the CPU under NO_FSDP_RULES, with and
without ``moe_ep`` (the expert-parallel branch then reshards the
d_ff-split experts at use), aggregate_gaussian fused b = 8, against the
JAX package's own compressed step jitted on a (2, 1, 2) host mesh
(tests/test_torch_mesh_train.py holds the dense kind's):

  * each pod's whole-leaf gradient within 1e-4 max|g| of the reference's
    value_and_grad on the pod's rows (a pod routes its rows as one call);
  * the summed words of every leaf, at each step, the reference's on
    every device, but for at most WORD_FLIPS of them (a word where the
    two gradients straddle a rounding boundary, as the dense kind's test
    allows: 0 or 1 of 51,712 in the ep case, from one run to the next,
    none in the tp case), and the losses within 1e-6 relative;
  * the parameters bitwise equal across pods for each model rank, the
    cohort 2.

phi3.5-moe's smoke config in f32 at capacity factor 2.0, its constant
leaves drawn away from 0 and 1, one torch thread per rank."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_moe_mesh_ranks as mmr
import torch_ranks
from repro import configs as jconfigs
from repro.dist import compress as jc
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.train import steps as jsteps
from test_torch_mesh import _params
from test_torch_mesh_train import (FUSED, GRAD_REL, LOSS_REL, WORD_FLIPS,
                                   _by_pod, _on_mesh, _ref_loss_and_grads)

PHI = "phi3.5-moe-42b-a6.6b"
VARIANTS = {"tp": {"capacity_factor": 2.0},
            "ep": {"capacity_factor": 2.0, "moe_ep": True}}
POD_SEED, POD_STEPS = 9, 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pods():
    """Both variants' POD_STEPS steps in one spawn of 4 ranks."""
    cfg_j = jconfigs.get_smoke_config(PHI).scaled(compute_dtype="float32")
    params = _params(cfg_j, seed=1)
    tokens = np.random.default_rng(6).integers(0, cfg_j.vocab, size=(4, 16),
                                               dtype=np.int32)
    jobs = [("torch_mesh_ranks", "train_side",
             ((2, 1, 2), PHI, params, tokens, FUSED, 1, False, POD_STEPS,
              POD_SEED, None, "adamw", kw)) for kw in VARIANTS.values()]
    got = torch_ranks.run_ranks(mmr.jobs_side, 4, jobs)
    return {"params": params, "tokens": tokens,
            "ranks": {v: [g[i] for g in got] for i, v in enumerate(VARIANTS)}}


def _ref_pods(cfg_j, params, tokens):
    """The reference's compressed step on a (2, 1, 2) host mesh with Auto
    axes, its state placed by its own rules, POD_STEPS times: losses,
    cohort and each step's summed words (read on every device by a debug
    callback), as tests/test_torch_mesh_train.py's reference fixture."""
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
    sh = jsteps.train_state_shardings(cfg_j, tc, mesh)
    state = jax.device_put(jax.tree.map(
        lambda x: jnp.array(x, dtype=x.dtype), state), sh)
    out = {"losses": [], "words": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(jc, "_psum_msg", psum)
    try:
        step = jax.jit(jsteps.build_train_step(cfg_j, tc, mesh),
                       out_shardings=(sh, None))
        for _ in range(POD_STEPS):
            state, m = _on_mesh(mesh, lambda: step(
                state, {"tokens": jnp.asarray(tokens)}, POD_SEED))
            jax.effects_barrier()
            out["losses"].append(float(m["loss"]))
            out["cohort"] = int(m["cohort"])
            out["words"].append([list(v) for _, v in sorted(seen.items())
                                 if v])
            for v in seen.values():
                v.clear()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_compressed_moe_pods_match_the_reference(pods, variant):
    """(2, 1, 2) under NO_FSDP_RULES: each pod's first-step whole-leaf
    gradient within 1e-4 max|g| of the reference's on its rows; at every
    step the summed words, leaf by leaf, the reference's compressed
    step's (the same on its 4 devices) but for at most WORD_FLIPS of
    them, and the same on every rank; the losses within 1e-6 relative;
    the cohort 2."""
    cfg_j = jconfigs.get_smoke_config(PHI).scaled(compute_dtype="float32",
                                                  **VARIANTS[variant])
    ranks = pods["ranks"][variant]
    vg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))
    by_pod = _by_pod(ranks)
    for c, t in enumerate(np.split(pods["tokens"], 2)):
        want = _ref_loss_and_grads(vg, pods["params"], t, 1)[1]
        for got, w in zip(by_pod[c][0]["records"][0]["grads"], want):
            assert got.shape == w.shape
            scale = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(got - w).max() <= GRAD_REL * scale
    ref = _ref_pods(cfg_j, pods["params"], pods["tokens"])
    assert ref["cohort"] == 2
    for s in range(POD_STEPS):
        ours = ranks[0]["records"][s]["words"]
        assert len(ref["words"][s]) == len(ours)
        differ = total = 0
        for i, b in enumerate(ours):
            assert len(ref["words"][s][i]) == 4
            for a in ref["words"][s][i]:
                np.testing.assert_array_equal(a, ref["words"][s][i][0])
            differ += int((ref["words"][s][i][0] != b).sum())
            total += b.size
        assert differ <= WORD_FLIPS * total
        for g in ranks:
            for a, b in zip(g["records"][s]["words"], ours):
                np.testing.assert_array_equal(a, b)
            want = ref["losses"][s]
            assert abs(g["losses"][s] - want) <= LOSS_REL * abs(want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_compressed_moe_params_bitwise_across_pods(pods, variant):
    """After each step the two pods' ranks of one model rank hold the same
    parameter bits; every rank's losses are finite and the cohort 2."""
    ranks = pods["ranks"][variant]
    by_model = {}
    for g in ranks:
        by_model.setdefault(g["coords"]["model"], []).append(g)
    for members in by_model.values():
        assert len(members) == 2
        assert members[0]["local_digest"] == members[1]["local_digest"]
    assert all(g["cohort"] == 2 for g in ranks)
    assert all(np.isfinite(x) for g in ranks for x in g["losses"])
