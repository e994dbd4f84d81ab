"""The moe kind on the port's (pod, data, model) mesh over gloo ranks on
the CPU (tests/torch_moe_mesh_ranks.py holds the rank sides), against
the JAX package's ``moe_block`` jitted on a host mesh of the same shape
and the port on one rank:

  * ``moe_block`` alone on (1, 1, 2), (1, 1, 4), (1, 2, 1) and (1, 2, 2),
    under the tensor-parallel branch (PARAM_RULES: each expert's d_ff
    split over ``model``) and the expert-parallel one (``moe_ep``, under
    EP_PARAM_RULES, and under NO_FSDP_RULES, whose d_ff-split experts are
    resharded at use): each rank's experts, positions and keep mask
    bitwise the reference's routing of that rank's rows, the output
    within 1e-5 max|y| and every gradient within 1e-4 max|g| of the
    reference's jitted value_and_grad on the same mesh, and of one rank;
  * capacity per shard: where it binds (a router skewed toward expert 0,
    capacity factor 1.0) the reference's mesh output differs from its
    one-device output, and the port's equals the reference's mesh one;
  * the all-to-all of ``dist.collectives`` and its gradient, exact in
    f64, on 2 and 4 ranks;
  * the train step on (1, 2, 2), FSDP + TP and FSDP + EP: the loss within
    1e-6 relative and each gathered gradient leaf within 1e-4 max|g| of
    the reference's value_and_grad on a (1, 2, 2) host mesh and of one
    rank; checkpoints written under each rule table restore under the
    other, and onto one rank, bit for bit;
  * ``ServeEngine(mesh=)`` on (1, 1, 2) under both branches: the f32
    tokens of one rank's engine, one request a prefill call;
  * the moe smoke arch through both launchers on 2 CPU processes.

The compressed (2, 1, 2) step is in tests/test_torch_moe_mesh_pods.py.
The smoke configs of phi3.5-moe and dbrx in f32 (their constant leaves
drawn away from 0 and 1), one torch thread per rank; the block cases at
capacity factor 2.0, where no choice is dropped on any shard or on one
rank, but for the binding case."""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_mesh_ranks as mr
import torch_moe_mesh_ranks as mmr
import torch_ranks
from repro import configs as jconfigs
from repro.dist import compress as jc
from repro.dist import meshctx as jmeshctx
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.train import steps as jsteps
from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.dist import compress as dcompress
from repro_torch.dist import meshctx
from repro_torch.launch import serve as launch
from repro_torch.models import moe, registry, transformer
from repro_torch.serve import ServeEngine
from repro_torch.train import steps
from test_torch_mesh import _params
from test_torch_moe import _jroute

OUT_REL = 1e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-6
PHI = "phi3.5-moe-42b-a6.6b"
DBRX = "dbrx-132b"
NAMES = ("router", "w_gate", "w_up", "w_down")
# (name, arch, config overrides, rule table)
BLOCK_CASES = (
    ("tp", PHI, {"capacity_factor": 2.0}, "PARAM_RULES"),
    ("ep", PHI, {"capacity_factor": 2.0, "moe_ep": True}, "EP_PARAM_RULES"),
    ("ep_reshard", PHI, {"capacity_factor": 2.0, "moe_ep": True},
     "NO_FSDP_RULES"),
    ("dbrx_tp", DBRX, {"capacity_factor": 2.0, "top_k": 4}, "PARAM_RULES"),
    ("dbrx_ep", DBRX, {"capacity_factor": 2.0, "top_k": 4, "moe_ep": True},
     "EP_PARAM_RULES"),
)
BIND = ("bind", PHI, {"capacity_factor": 1.0}, "PARAM_RULES")
SHAPES = ((1, 1, 2), (1, 1, 4), (1, 2, 1), (1, 2, 2))
BLOCK_B, BLOCK_T = 2, 24
TRAIN_ACCUM = 2
SERVE_GEN = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cases(shape):
    return BLOCK_CASES + ((BIND,) if shape[1] > 1 else ())


def _cfg_pair(arch, kw):
    return (jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32",
                                                   **kw),
            configs.get_smoke_config(arch).scaled(compute_dtype="float32",
                                                  **kw))


def _block_inputs(cfg):
    """Seeded weights of one moe layer, x (BLOCK_B, BLOCK_T, D) and the
    loss's cotangent c; for the binding case x's first coordinate is
    shifted by 2 and the router's (0, 0) entry by 10, so that nearly every
    token's first choice is expert 0."""
    rng = np.random.default_rng(0)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": rng.normal(size=(d, e)).astype(np.float32),
         "w_gate": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
         "w_up": (rng.normal(size=(e, d, f)) / 8).astype(np.float32),
         "w_down": (rng.normal(size=(e, f, d)) / 10).astype(np.float32)}
    x = rng.normal(size=(BLOCK_B, BLOCK_T, d)).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)
    bind = dict(w, router=w["router"].copy())
    bind["router"][0, 0] += 10.0
    xb = x.copy()
    xb[..., 0] += 2.0
    return w, x, c, bind, xb


def _host_mesh(shape):
    return jax.make_mesh(shape, ("pod", "data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(AxisType.Auto,) * 3)


def _on_mesh(mesh, fn):
    prev = jmeshctx._mesh
    jmeshctx._mesh = mesh
    try:
        return fn()
    finally:
        jmeshctx._mesh = prev


def _ref_block(cfg_j, mesh, w, x, c):
    """The reference's jitted moe_block on ``mesh``: y and the gradients
    of sum(y * c) for x and each weight."""
    def loss(x, ws):
        y = jmoe.moe_block(cfg_j, {"moe": ws}, x)
        return jnp.sum(y * jnp.asarray(c)), y

    f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, y), (dx, dw) = _on_mesh(mesh, lambda: f(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}))
    return {"y": np.asarray(y), "dx": np.asarray(dx),
            "grads": {k: np.asarray(v) for k, v in dw.items()}}


def _one_rank_block(cfg, w, x, c):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    y = moe.local_moe(cfg, xt, *(wt[k] for k in NAMES))
    (y * torch.from_numpy(c)).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "grads": {k: wt[k].grad.numpy() for k in NAMES}}


def _close(got, want, rel):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _train_cfg(kw):
    return ({"capacity_factor": 2.0} | kw)


TRAIN_VARIANTS = {"tp": {}, "ep": {"moe_ep": True}}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """Both spawns: 4 ranks for the (1, 1, 4) and (1, 2, 2) blocks, the
    (1, 2, 2) train steps (each saving its state), and each checkpoint
    restored under the other rule table; 2 ranks for the (1, 1, 2) and
    (1, 2, 1) blocks and the (1, 1, 2) engines."""
    cfg = configs.get_smoke_config(PHI).scaled(compute_dtype="float32")
    w, x, c, wb, xb = _block_inputs(cfg)
    cfg_j = jconfigs.get_smoke_config(PHI).scaled(compute_dtype="float32")
    params = _params(cfg_j, seed=1)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(4, 16),
                                               dtype=np.int32)
    ckpt = {v: str(tmp_path_factory.mktemp(f"moe_ckpt_{v}"))
            for v in TRAIN_VARIANTS}
    other = {"tp": "ep", "ep": "tp"}

    def block_jobs(shape):
        out = [("torch_moe_mesh_ranks", "block_side",
                (shape, BLOCK_CASES, w, x, c))]
        if shape[1] > 1:
            out.append(("torch_moe_mesh_ranks", "block_side",
                        (shape, (BIND,), wb, xb, c)))
        return out

    four = (block_jobs((1, 1, 4)) + block_jobs((1, 2, 2)) + [
        ("torch_mesh_ranks", "train_side",
         ((1, 2, 2), PHI, params, tokens, None, TRAIN_ACCUM, False, 1, 0,
          ckpt[v], "adamw", _train_cfg(kw)))
        for v, kw in TRAIN_VARIANTS.items()] + [
        ("torch_mesh_ranks", "restore_side",
         ((1, 2, 2), PHI, None, ckpt[v], _train_cfg(TRAIN_VARIANTS[other[v]])))
        for v in TRAIN_VARIANTS])
    got4 = torch_ranks.run_ranks(mmr.jobs_side, 4, four)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, size=(4, 8),
                                                dtype=np.int32)
    requests = [(r, np.random.default_rng(10 + r).integers(
        0, cfg.vocab, size=(3 + r,), dtype=np.int32), 3 + r % 3)
        for r in range(4)]
    two = block_jobs((1, 1, 2)) + block_jobs((1, 2, 1)) + [
        ("torch_moe_mesh_ranks", "serve_side",
         ((1, 1, 2), PHI, _train_cfg(kw), params, prompts, SERVE_GEN,
          requests)) for kw in TRAIN_VARIANTS.values()]
    got2 = torch_ranks.run_ranks(mmr.jobs_side, 2, two)

    def take(got, i):
        return [g[i] for g in got]

    out = {"w": w, "x": x, "c": c, "wb": wb, "xb": xb, "params": params,
           "tokens": tokens, "ckpt": ckpt, "prompts": prompts,
           "requests": requests, "blocks": {}, "bind": {}}
    i = 0
    for shape in ((1, 1, 4), (1, 2, 2)):
        out["blocks"][shape] = take(got4, i)
        i += 1
        if shape[1] > 1:
            out["bind"][shape] = take(got4, i)
            i += 1
    out["train"] = {v: take(got4, i + j) for j, v in enumerate(TRAIN_VARIANTS)}
    i += len(TRAIN_VARIANTS)
    out["restored"] = {v: take(got4, i + j)
                       for j, v in enumerate(TRAIN_VARIANTS)}
    i = 0
    for shape in ((1, 1, 2), (1, 2, 1)):
        out["blocks"][shape] = take(got2, i)
        i += 1
        if shape[1] > 1:
            out["bind"][shape] = take(got2, i)
            i += 1
    out["serve"] = {v: take(got2, i + j) for j, v in enumerate(TRAIN_VARIANTS)}
    return out


def _shard_rows(mesh_shape, coords, x):
    """The rows of x the rank at ``coords`` routes: its block along the
    batch axes that divide B (pod, then data)."""
    n, i = 1, 0
    for a, size in (("pod", mesh_shape[0]), ("data", mesh_shape[1])):
        if size > 1 and x.shape[0] % (n * size) == 0:
            n, i = n * size, i * size + coords[a]
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _routes_match(cfg_j, shape, ranks, name, x, router):
    """Every rank's one route call bitwise the reference's routing of
    the rows it holds; returns whether any choice was dropped."""
    dropped = False
    for g in ranks:
        (route,) = g["cases"][name]["routes"]
        top_e, pos, keep, C = route
        rows = _shard_rows(shape, g["coords"], x).reshape(-1, x.shape[-1])
        want = _jroute(cfg_j, jnp.asarray(rows), jnp.asarray(router))
        assert C == jmoe.capacity(rows.shape[0], cfg_j)
        np.testing.assert_array_equal(top_e, want[1])
        np.testing.assert_array_equal(pos, want[2])
        np.testing.assert_array_equal(keep, want[3])
        dropped |= not keep.all()
    return dropped


@pytest.fixture(scope="module")
def ref_blocks(ran):
    """The reference's jitted block on each host mesh, for every case."""
    out = {}
    for shape in SHAPES:
        mesh = _host_mesh(shape)
        for name, arch, kw, _ in _cases(shape):
            cfg_j = _cfg_pair(arch, kw)[0]
            w, x = ((ran["wb"], ran["xb"]) if name == "bind"
                    else (ran["w"], ran["x"]))
            out[shape, name] = _ref_block(cfg_j, mesh, w, x, ran["c"])
    return out


@pytest.mark.parametrize("name", [c[0] for c in BLOCK_CASES])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_block_matches_reference_on_the_mesh(ran, ref_blocks, shape, name):
    """Routing bitwise on every rank's rows; the output within 1e-5
    max|y| and every gradient within 1e-4 max|g| of the reference's on
    the same mesh, every rank gathering the same; no choice dropped."""
    arch, kw, rules = next(c[1:] for c in BLOCK_CASES if c[0] == name)
    cfg_j, cfg = _cfg_pair(arch, kw)
    ranks = ran["blocks"][shape]
    assert not _routes_match(cfg_j, shape, ranks, name, ran["x"],
                             ran["w"]["router"])
    want = ref_blocks[shape, name]
    got = ranks[0]["cases"][name]
    for g in ranks[1:]:
        np.testing.assert_array_equal(g["cases"][name]["y"], got["y"])
    _close(got["y"], want["y"], OUT_REL)
    _close(got["dx"], want["dx"], GRAD_REL)
    for k in NAMES:
        _close(got["grads"][k], want["grads"][k], GRAD_REL)
    # each rank holds the layout its table gives
    E, F = cfg.n_experts, cfg.d_ff
    e_l, f_l = got["local_shapes"]["w_gate"][0], got["local_shapes"][
        "w_gate"][2]
    if rules == "EP_PARAM_RULES" and E % shape[2] == 0:
        assert (e_l, f_l) == (E // shape[2], F)
    else:
        assert (e_l, f_l) == (E, F // shape[2])


@pytest.mark.parametrize("name", [c[0] for c in BLOCK_CASES])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_block_matches_one_rank(ran, shape, name):
    """Where no choice is dropped, the mesh's block is the one-rank
    block: output within 1e-5 max|y|, gradients within 1e-4 max|g|."""
    arch, kw, _ = next(c[1:] for c in BLOCK_CASES if c[0] == name)
    cfg = _cfg_pair(arch, kw)[1]
    want = _one_rank_block(cfg, ran["w"], ran["x"], ran["c"])
    got = ran["blocks"][shape][0]["cases"][name]
    _close(got["y"], want["y"], OUT_REL)
    _close(got["dx"], want["dx"], GRAD_REL)
    for k in NAMES:
        _close(got["grads"][k], want["grads"][k], GRAD_REL)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] > 1],
                         ids=lambda s: "x".join(map(str, s)))
def test_capacity_is_per_shard(ran, ref_blocks, shape):
    """A router skewed toward expert 0 at capacity factor 1.0: each data
    rank drops choices with the capacity of its own rows, bitwise as the
    reference routes that shard; the reference's mesh output differs
    from its one-device output, and the port's is the mesh one (1e-5
    max|y|, gradients 1e-4 max|g|)."""
    name, arch, kw, _ = BIND
    cfg_j, cfg = _cfg_pair(arch, kw)
    ranks = ran["bind"][shape]
    assert _routes_match(cfg_j, shape, ranks, name, ran["xb"],
                         ran["wb"]["router"])
    want = ref_blocks[shape, name]
    one = _ref_block(cfg_j, _host_mesh((1, 1, 1)), ran["wb"], ran["xb"],
                     ran["c"])
    gap = np.abs(one["y"] - want["y"]).max() / np.abs(want["y"]).max()
    assert gap > 1e-2
    got = ranks[0]["cases"][name]
    _close(got["y"], want["y"], OUT_REL)
    _close(got["dx"], want["dx"], GRAD_REL)
    for k in NAMES:
        _close(got["grads"][k], want["grads"][k], GRAD_REL)
    assert np.abs(_one_rank_block(cfg, ran["wb"], ran["xb"], ran["c"])["y"]
                  - got["y"]).max() > 1e-2 * np.abs(want["y"]).max()


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_exchange_and_its_gradient(ran, shape):
    """``coll.all_to_all`` and the ``exchange`` Function on 2 and 4 model
    ranks: block i of dim 0 to rank i, the received blocks stacked by
    sender, and the gradient the same exchange of the cotangent, exact
    in f64."""
    for g in ran["blocks"][shape]:
        assert g["exchange"] == {"plain": True, "y": True, "grad": True,
                                 "dtype": "torch.float64"}


def _ref_train(cfg_j, params, tokens):
    """The reference's jitted value_and_grad of its loss on a (1, 2, 2)
    host mesh (each data shard routes its rows), over TRAIN_ACCUM
    microbatches in order, averaged as its step averages them."""
    vg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))
    p = jax.tree.map(jnp.asarray, params)
    parts = _on_mesh(_host_mesh((1, 2, 2)), lambda: [
        vg(p, {"tokens": jnp.asarray(t)})
        for t in np.split(tokens, TRAIN_ACCUM)])
    loss = sum(float(l) for l, _ in parts) / TRAIN_ACCUM
    grads = jax.tree.map(lambda *g: sum(g) / TRAIN_ACCUM,
                         *(g for _, g in parts))
    return loss, [np.asarray(x) for x in jax.tree.leaves(grads)]


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_train_step_matches_reference_and_one_rank(ran, variant):
    """(1, 2, 2), FSDP + TP (PARAM_RULES) and FSDP + EP (EP_PARAM_RULES):
    the mean loss within 1e-6 relative and every gathered gradient leaf
    within 1e-4 max|g| of the reference's value_and_grad on a (1, 2, 2)
    host mesh and of the one-rank port; every rank gathers the same
    leaves; the expert leaves are held as the table places them."""
    kw = _train_cfg(TRAIN_VARIANTS[variant])
    cfg_j, cfg = _cfg_pair(PHI, kw)
    ranks = ran["train"][variant]
    ref_loss, ref_grads = _ref_train(cfg_j, ran["params"], ran["tokens"])
    tc = steps.TrainConfig(optimizer="sgd", lr=3e-3, grad_accum=TRAIN_ACCUM)
    one_loss, one = steps.loss_and_grads(
        cfg, tc, mr._tree(ran["params"]),
        {"tokens": torch.from_numpy(ran["tokens"])})
    one = [x.numpy() for x in mr._leaves(one)]
    for g in ranks:
        for a, b in zip(g["grads"], ranks[0]["grads"]):
            np.testing.assert_array_equal(a, b)
    g = ranks[0]
    for want_loss, want in ((ref_loss, ref_grads), (float(one_loss), one)):
        assert abs(g["loss"] - want_loss) <= LOSS_REL * abs(want_loss)
        assert len(g["grads"]) == len(want)
        for got, w in zip(g["grads"], want):
            _close(got, w, GRAD_REL)
    sh = steps.train_state_shardings(cfg, tc, meshctx.Mesh((1, 2, 2)))
    assert tuple(sh["params"]["layers"]["moe"]["w_gate"].spec) == (
        (None, "model", "data", None) if variant == "ep"
        else (None, None, "data", "model"))


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_specs(tree[k], path + (k,))
    else:
        yield path, tuple(tree.spec)


@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 1, 2), (1, 2, 2),
                                   (1, 1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_train_state_shardings_pick_the_reference_table(shape, ep, comp):
    """``steps.train_state_shardings`` places phi3.5-moe's and dbrx's
    parameters (full configs) as the reference's does on the same mesh:
    EP_PARAM_RULES under ``moe_ep``, NO_FSDP_RULES for a compressed step
    over ``pod`` (which wins over EP), PARAM_RULES otherwise."""
    jmesh = jax.make_mesh(shape, ("pod", "data", "model"),
                          devices=jax.devices()[:int(np.prod(shape))])
    kw = dict(mechanism="aggregate_gaussian", sigma=1e-3)
    jtc = jsteps.TrainConfig(
        compression=jc.CompressionConfig(**kw) if comp else None)
    tc = steps.TrainConfig(
        compression=dcompress.CompressionConfig(**kw) if comp else None)
    for arch in (PHI, DBRX):
        want = jsteps.train_state_shardings(
            jconfigs.get_config(arch).scaled(moe_ep=ep), jtc,
            jmesh)["params"]
        got = steps.train_state_shardings(
            configs.get_config(arch).scaled(moe_ep=ep), tc,
            meshctx.Mesh(shape))["params"]
        assert list(_flat_specs(got)) == list(_flat_specs(want))


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_checkpoint_moves_across_rule_tables(ran, variant):
    """A state written on (1, 2, 2) under one rule table (PARAM_RULES for
    tp, EP_PARAM_RULES for ep) restores under the other on (1, 2, 2) and
    onto one rank: every gathered leaf bitwise the saved one."""
    saved = ran["train"][variant][0]["saved"]
    other = {"tp": "ep", "ep": "tp"}[variant]
    cfg = _cfg_pair(PHI, _train_cfg(TRAIN_VARIANTS[other]))[1]
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-3)
    one, step = steps.restore_train_state(ran["ckpt"][variant], cfg, tc,
                                          device="cpu")
    assert step == 1
    leaves = [x.numpy() for x in mr._leaves(one)]
    n = len(saved)
    for a, b in zip(leaves[2 * n + 1:3 * n + 1], saved):
        np.testing.assert_array_equal(a, b)
    for r in ran["restored"][variant]:
        assert r["step"] == 1
        for a, b in zip(r["whole"], leaves):
            np.testing.assert_array_equal(a, b)
    E = cfg.n_experts
    w_gate = (E // 2, cfg.d_model // 2, cfg.d_ff) if other == "ep" else (
        E, cfg.d_model // 2, cfg.d_ff // 2)
    assert (cfg.n_layers,) + w_gate in ran["restored"][variant][0][
        "local_shapes"]


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_engine_on_the_mesh_matches_one_rank(ran, variant):
    """(1, 1, 2), weights resident by SERVE_RESIDENT_RULES (d_ff split;
    under moe_ep the experts resharded at use): the f32 engine's tokens
    at full occupancy and ``drive``'s over mixed requests equal the
    one-rank engine's, each prompt its own prefill (capacity is per
    call); a decode step of 4 slots cannot drop a choice."""
    cfg = _cfg_pair(PHI, _train_cfg(TRAIN_VARIANTS[variant]))[1]
    model = transformer.Transformer(cfg, mr._tree(ran["params"]))
    prompts = ran["prompts"]
    engine = ServeEngine(cfg, max_slots=prompts.shape[0],
                         max_prefill_len=prompts.shape[1],
                         max_gen_len=SERVE_GEN, device="cpu")
    want = mr._engine_tokens(engine, model, prompts, SERVE_GEN)
    want_drive, _ = launch.drive(
        ServeEngine(cfg, max_slots=2, max_prefill_len=prompts.shape[1],
                    max_gen_len=SERVE_GEN, device="cpu"), model,
        ran["requests"])
    for g in ran["serve"][variant]:
        np.testing.assert_array_equal(g["engine"], want)
        assert g["drive"] == want_drive
        assert g["w_gate"] == (cfg.n_experts, cfg.d_model, cfg.d_ff // 2)


SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _launch(module, args, world):
    port = torch_ranks.free_port()
    procs = []
    for r in range(max(world, 1)):
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        if world:
            env.update(RANK=str(r), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *args], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out = []
    for p in procs:
        o, e = p.communicate(timeout=180)
        out.append((p.returncode, o, e))
    return out


def test_launchers_run_moe_on_two_ranks():
    """phi3.5-moe's smoke arch under RANK / WORLD_SIZE on a (data=2)
    mesh.  Train: each rank routes its 2 rows with their own capacity, so
    the step-0 loss is the mean of the one-process loss of each half of
    the batch (to the printed 4 decimals), not the whole batch's.  Serve:
    every prompt is prefilled whole on every rank and each rank decodes
    its 2 slots, which cannot drop a choice: the single process's
    tokens."""
    args = ["--arch", PHI, "--smoke", "--device", "cpu", "--steps", "1",
            "--batch", "4", "--seq", "16"]
    two = _launch("repro_torch.launch.train", args, 2)
    for rc, _, err in two:
        assert rc == 0, err[-2000:]
    got = float(re.search(r"step +0 loss ([0-9.]+)", two[0][1]).group(1))
    cfg = configs.get_smoke_config(PHI).scaled(compute_dtype="float32")
    state = steps.init_train_state(cfg, steps.TrainConfig(), 0, "cpu")
    dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                              kind="lm")
    tokens = synthetic.batch_fn(dc)(dc, 0, device="cpu")["tokens"]
    loss = registry.loss_fn(cfg)
    with torch.no_grad():
        halves = [float(loss(state["params"], {"tokens": t}))
                  for t in tokens.split(2)]
    assert abs(got - sum(halves) / 2) <= 6e-5
    assert "[train] done" in two[0][1] and two[1][1] == ""
    serve = ["--arch", PHI, "--smoke", "--device", "cpu", "--requests", "4",
             "--slots", "4", "--prompt-len", "8", "--gen", "4"]
    two = _launch("repro_torch.launch.serve", serve, 2)
    one = _launch("repro_torch.launch.serve", serve, 0)
    for rc, _, err in two + one:
        assert rc == 0, err[-2000:]
    sample = re.compile(r"sample token ids: (.*)")
    assert sample.search(two[0][1]).group(1) == sample.search(
        one[0][1]).group(1)
    assert two[1][1] == ""
