"""rwkv6 on the port's (pod, data, model) mesh over gloo ranks on the CPU
(tests/torch_family_mesh_ranks.py holds the rank sides), against the JAX
package jitted on a host mesh of the same shape (Auto axes) and the port
on one rank:

  * the forward on (1, 1, 2) and (1, 1, 4) (the smoke config's 4 heads of
    16: 2 or 1 a rank), weights by SERVE_RESIDENT_RULES: f32 logits within
    1e-5 max|logit| of the reference's and of one rank's, the same on
    every rank; bf16 logits no further from the f32 ones than 1.5 times
    the one-rank bf16 forward's;
  * serving on both meshes: the f32 engine's tokens, the naive loop's and
    ``drive``'s equal one rank's; the decode state after a chain of
    ``serve_fn`` steps, gathered whole, within 1e-5 of its max from one
    rank's; the pool's blocks (wkv by heads, the shift tokens by D);
  * training on (1, 2, 2), FSDP + TP, with and without gather_once: the
    loss within 1e-6 relative and every gathered gradient leaf within
    1e-4 max|g| of the reference's value_and_grad on a (1, 2, 2) host
    mesh and of one rank;
  * the compressed step on (2, 1, 2), aggregate_gaussian fused b = 8: the
    summed words of every leaf the reference's own compressed step's,
    bitwise, on every rank; the loss within 1e-6 relative; the params
    bitwise equal across pods; its checkpoint restored onto (1, 2, 2)
    and onto one rank bit for bit;
  * ``nn.rms_norm(group=)`` (``ln_x``'s norm over a D split over model)
    on 2 and 4 ranks: values and gradients within 1e-6 of the whole
    norm's;
  * both launchers under RANK / WORLD_SIZE on 2 CPU processes: the single
    process's step-0 loss and sample tokens.

The smoke config in f32, the zero-initialised leaves drawn nonzero
(``test_torch_rwkv6._params``), one torch thread per rank."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_family_mesh_ranks as fr
import torch_mesh_ranks as mr
import torch_moe_mesh_ranks as mmr
import torch_ranks
from repro import configs as jconfigs
from repro.dist import meshctx as jmeshctx
from repro.models import registry as jregistry
from repro_torch.launch import serve as launch
from repro_torch.models import nn, registry
from repro_torch.serve import ServeEngine, naive_generate
from repro_torch.train import steps
from test_torch_mesh_launch import _launch
from test_torch_mesh_train import FUSED
from test_torch_moe_mesh_pods import POD_SEED, POD_STEPS, _ref_pods
from test_torch_rwkv6 import _np, _params

ARCH = "rwkv6-1.6b"
LOGIT_REL = 1e-5
STATE_REL = 1e-5
BF16_FACTOR = 1.5
LOSS_REL = 1e-6
GRAD_REL = 1e-4
NORM_REL = 1e-6
SERVE = ((1, 1, 2), (1, 1, 4))
N_GEN = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfgs(arch):
    return (jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32"),
            mr._cfg(arch))


def host_mesh(shape):
    return jax.make_mesh(shape, ("pod", "data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(AxisType.Auto,) * 3)


def on_mesh(mesh, fn):
    prev = jmeshctx._mesh
    jmeshctx._mesh = mesh
    try:
        return fn()
    finally:
        jmeshctx._mesh = prev


def ref_logits(cfg_j, params, batch, shape):
    """The reference's jitted ``logits_fn`` on a host mesh of ``shape``."""
    f = jax.jit(lambda p, b: jregistry.logits_fn(cfg_j, p, b))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    return np.asarray(on_mesh(host_mesh(shape), lambda: f(params, b)))


def ref_loss_and_grads(cfg_j, params, batch, shape, accum):
    """The reference's jitted value_and_grad of its loss on a host mesh
    of ``shape``, over ``accum`` microbatches in order, averaged as its
    step averages them."""
    vg = jax.jit(jax.value_and_grad(jregistry.loss_fn(cfg_j)))
    p = jax.tree.map(jnp.asarray, params)
    parts = on_mesh(host_mesh(shape), lambda: [
        vg(p, {k: jnp.asarray(np.split(v, accum)[i])
               for k, v in batch.items()}) for i in range(accum)])
    loss = sum(float(l) for l, _ in parts) / accum
    grads = jax.tree.map(lambda *g: sum(g) / accum, *(g for _, g in parts))
    return loss, [np.asarray(x) for x in jax.tree.leaves(grads)]


def close(got, want, rel):
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def one_rank_serve(cfg, model, prompts, requests, chain):
    """The one-rank port's engine, naive-loop and drive tokens, and the
    decode state after ``chain``."""
    P = prompts.shape[1]
    engine = ServeEngine(cfg, max_slots=prompts.shape[0], max_prefill_len=P,
                         max_gen_len=N_GEN, device="cpu")
    drive, _ = launch.drive(
        ServeEngine(cfg, max_slots=2, max_prefill_len=P, max_gen_len=N_GEN,
                    device="cpu"), model, requests)
    B, T = chain.shape
    state = registry.init_decode_state(cfg, B, T, "cpu")
    serve = registry.serve_fn(cfg)
    with torch.no_grad():
        for t in range(T):
            logits, state = serve(model, {"tokens": torch.from_numpy(
                chain[:, t:t + 1])}, state)
    return {"engine": mr._engine_tokens(engine, model, prompts, N_GEN),
            "naive": naive_generate(cfg, model,
                                    {"tokens": torch.from_numpy(prompts)},
                                    N_GEN).numpy(),
            "drive": drive, "chain_logits": logits.numpy(),
            "state": {k: v.numpy() for k, v in state.items()}}


def one_rank_grads(cfg, params, batch, accum):
    tc = steps.TrainConfig(optimizer="sgd", lr=3e-3, grad_accum=accum)
    loss, g = steps.loss_and_grads(
        cfg, tc, mr._tree(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), [x.numpy() for x in mr._leaves(g)]


def requests_of(cfg, n, p, seed):
    rng = np.random.default_rng(seed)
    return [(r, rng.integers(0, cfg.vocab, size=(int(rng.integers(2, p + 1)),),
                             dtype=np.int32), 3 + r % 3) for r in range(n)]


def spawn(jobs4, jobs2):
    """Both spawns: 4 ranks for ``jobs4``, 2 for ``jobs2``; each job's
    results by rank."""
    got4 = torch_ranks.run_ranks(mmr.jobs_side, 4, jobs4)
    got2 = torch_ranks.run_ranks(mmr.jobs_side, 2, jobs2)
    return ([[g[i] for g in got4] for i in range(len(jobs4))],
            [[g[i] for g in got2] for i in range(len(jobs2))])


def norm_inputs(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    c = rng.standard_normal((3, 5, 64)).astype(np.float32)
    return x, w, c


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    cfg_j, cfg = cfgs(ARCH)
    params = _np(_params(cfg_j, seed=1))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, size=(2, 16), dtype=np.int32)
    train = rng.integers(0, cfg.vocab, size=(4, 16), dtype=np.int32)
    prompts = rng.integers(0, cfg.vocab, size=(4, 6), dtype=np.int32)
    chain = rng.integers(0, cfg.vocab, size=(2, 5), dtype=np.int32)
    requests = requests_of(cfg, 5, 6, seed=4)
    ckpt = str(tmp_path_factory.mktemp("rwkv6_mesh_ckpt"))
    x, w, c = norm_inputs()
    fam = "torch_family_mesh_ranks"

    def serve_jobs(shape):
        return [(fam, "forward_side", (shape, ARCH, params, tokens)),
                (fam, "serve_side", (shape, ARCH, params, prompts, N_GEN,
                                     requests, chain)),
                (fam, "norm_side", (x, w, c))]

    train_args = (ARCH, params, train)
    four, two = spawn(serve_jobs((1, 1, 4)) + [
        ("torch_mesh_ranks", "train_side", ((1, 2, 2),) + train_args + (
            None, 2, once, 1, 0, None, "sgd")) for once in (False, True)] + [
        ("torch_mesh_ranks", "train_side", ((2, 1, 2),) + train_args + (
            FUSED, 1, False, POD_STEPS, POD_SEED, ckpt)),
        ("torch_mesh_ranks", "restore_side", ((1, 2, 2), ARCH, None, ckpt))],
        serve_jobs((1, 1, 2)))
    return {"cfg": cfg, "cfg_j": cfg_j, "params": params, "tokens": tokens,
            "train": train, "prompts": prompts, "chain": chain,
            "requests": requests, "ckpt": ckpt, "norm": (x, w, c),
            "forward": {(1, 1, 4): four[0], (1, 1, 2): two[0]},
            "serve": {(1, 1, 4): four[1], (1, 1, 2): two[1]},
            "norm_ranks": {4: four[2], 2: two[2]},
            "fsdp": four[3], "fsdp_once": four[4], "pods": four[5],
            "restored": four[6]}


@pytest.fixture(scope="module")
def one(ran):
    """The one-rank port on the fixture's inputs."""
    cfg = ran["cfg"]
    model = fr._model(cfg, ran["params"], None)
    bf16 = cfg.scaled(compute_dtype="bfloat16")
    batch = {"tokens": torch.from_numpy(ran["tokens"])}
    with torch.no_grad():
        logits = registry.logits_fn(cfg, model, batch).numpy()
        logits_bf16 = registry.logits_fn(bf16, model, batch).to(
            torch.float32).numpy()
    out = one_rank_serve(cfg, model, ran["prompts"], ran["requests"],
                         ran["chain"])
    out.update(logits=logits, logits_bf16=logits_bf16)
    out["loss"], out["grads"] = one_rank_grads(
        cfg, ran["params"], {"tokens": ran["train"]}, 2)
    return out


def check_forward(ran, one, shape, rel=LOGIT_REL):
    """f32 logits within ``rel`` max|logit| of one rank's and of the
    reference's on a host mesh of ``shape``, the same on every rank; bf16
    within BF16_FACTOR of the one-rank bf16 forward's distance from f32."""
    ranks = ran["forward"][shape]
    for g in ranks:
        np.testing.assert_array_equal(g["logits"], ranks[0]["logits"])
        np.testing.assert_array_equal(g["logits_bf16"],
                                      ranks[0]["logits_bf16"])
    got = ranks[0]["logits"]
    close(got, one["logits"], rel)
    batch = {"tokens": ran["tokens"]}
    if "frames" in ran:
        batch["frames"] = ran["frames"]
    close(got, ref_logits(ran["cfg_j"], ran["params"], batch, shape), rel)
    one_err = float(np.abs(one["logits_bf16"] - one["logits"]).max())
    assert 0.0 < one_err
    assert float(np.abs(ranks[0]["logits_bf16"] - one["logits"]).max()) \
        <= BF16_FACTOR * one_err


def check_serve(ran, one, shape):
    for g in ran["serve"][shape]:
        np.testing.assert_array_equal(g["engine"], one["engine"])
        np.testing.assert_array_equal(g["naive"], one["naive"])
        assert g["drive"] == one["drive"]
        close(g["chain_logits"], one["chain_logits"], LOGIT_REL)
        assert sorted(g["state"]) == sorted(one["state"])
        for k, v in one["state"].items():
            close(g["state"][k], v, STATE_REL)
    np.testing.assert_array_equal(one["engine"], one["naive"])


def check_train(ran, one, variant, cfg_j, batch, accum=2):
    ranks = ran[variant]
    ref_loss, ref_grads = ref_loss_and_grads(cfg_j, ran["params"], batch,
                                             (1, 2, 2), accum)
    for g in ranks:
        for a, b in zip(g["grads"], ranks[0]["grads"]):
            np.testing.assert_array_equal(a, b)
    g = ranks[0]
    for want_loss, want in ((ref_loss, ref_grads),
                            (one["loss"], one["grads"])):
        assert abs(g["loss"] - want_loss) <= LOSS_REL * abs(want_loss)
        assert len(g["grads"]) == len(want)
        for got, w in zip(g["grads"], want):
            close(got, w, GRAD_REL)


def check_params_across_pods(ranks):
    by_model = {}
    for g in ranks:
        by_model.setdefault(g["coords"]["model"], []).append(g)
    for members in by_model.values():
        assert len(members) == 2
        assert members[0]["local_digest"] == members[1]["local_digest"]
    assert all(g["cohort"] == 2 for g in ranks)
    assert all(np.isfinite(x) for g in ranks for x in g["losses"])


@pytest.mark.parametrize("shape", SERVE, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_reference_and_one_rank(ran, one, shape):
    check_forward(ran, one, shape)
    heads = ran["cfg"].n_heads // shape[2]
    local = ran["forward"][shape][0]["local_shapes"]
    D = ran["cfg"].d_model
    assert local["layers.0.wr"] == (D, D // shape[2]) and heads >= 1
    assert local["layers.0.wo"] == (D // shape[2], D)
    assert local["layers.0.ln_x"] == (D // shape[2],)
    assert local["layers.0.cr"] == (D, D)


@pytest.mark.parametrize("shape", SERVE, ids=lambda s: "x".join(map(str, s)))
def test_serving_matches_one_rank(ran, one, shape):
    """Engine, naive loop and drive tokens equal one rank's; the state
    after the chain within 1e-5; the pool holds the rank's heads of wkv
    and its block of D of the shift tokens."""
    check_serve(ran, one, shape)
    cfg, n = ran["cfg"], shape[2]
    L, H, D = cfg.n_layers, cfg.n_heads, cfg.d_model
    K = D // H
    pool = ran["serve"][shape][0]["pool"]
    assert pool["wkv"] == (L, 4, H // n, K, K)
    assert pool["prev_tm"] == pool["prev_cm"] == (L, 4, 1, D // n)


@pytest.mark.parametrize("variant", ["fsdp", "fsdp_once"])
def test_fsdp_tp_loss_and_gradient(ran, one, variant):
    check_train(ran, one, variant, ran["cfg_j"], {"tokens": ran["train"]})


def test_compressed_pods_match_the_reference(ran):
    """(2, 1, 2): each leaf's summed words bitwise the reference's own
    compressed step's (the same on its 4 devices) and the same on every
    rank; the loss within 1e-6 relative; params bitwise across pods."""
    ranks = ran["pods"]
    ref = _ref_pods(ran["cfg_j"], ran["params"], ran["train"])
    assert ref["cohort"] == 2
    for s in range(POD_STEPS):
        ours = ranks[0]["records"][s]["words"]
        assert len(ref["words"][s]) == len(ours)
        for i, b in enumerate(ours):
            assert len(ref["words"][s][i]) == 4
            for a in ref["words"][s][i]:
                np.testing.assert_array_equal(a, b)
        for g in ranks:
            for a, b in zip(g["records"][s]["words"], ours):
                np.testing.assert_array_equal(a, b)
            want = ref["losses"][s]
            assert abs(g["losses"][s] - want) <= LOSS_REL * abs(want)
    check_params_across_pods(ranks)


def test_checkpoint_restores_onto_other_meshes(ran):
    """Saved on (2, 1, 2) under NO_FSDP_RULES, restored onto (1, 2, 2)
    under PARAM_RULES and onto one rank: every gathered leaf bitwise the
    saved one; (1, 2, 2) holds blocks."""
    cfg = ran["cfg"]
    from repro_torch.dist import compress as dcompress

    tc = steps.TrainConfig(optimizer="adamw", lr=3e-3,
                           compression=dcompress.CompressionConfig(**FUSED))
    state, step = steps.restore_train_state(ran["ckpt"], cfg, tc,
                                            device="cpu")
    assert step == POD_STEPS
    leaves = [x.numpy() for x in mr._leaves(state)]
    saved = ran["pods"][0]["saved"]
    n = len(saved)
    for a, b in zip(leaves[2 * n + 1:3 * n + 1], saved):
        np.testing.assert_array_equal(a, b)
    for r in ran["restored"]:
        assert r["step"] == POD_STEPS
        for a, b in zip(r["whole"], leaves):
            np.testing.assert_array_equal(a, b)
    D, L = cfg.d_model, cfg.n_layers
    assert (L, D // 2, D // 2) in ran["restored"][0]["local_shapes"]


@pytest.mark.parametrize("n", [2, 4])
def test_split_rms_norm_is_the_whole_norm(ran, n):
    """``nn.rms_norm(group=)`` over a 64-wide dim split over n ranks:
    the blocks of y, dx and dw within 1e-6 of the whole norm's."""
    x, w, c = ran["norm"]
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = nn.rms_norm(xt, wt)
    (y * torch.from_numpy(c)).sum().backward()
    got = ran["norm_ranks"][n]
    for key, want in (("y", y.detach().numpy()), ("dx", xt.grad.numpy())):
        close(np.concatenate([g[key] for g in got], -1), want, NORM_REL)
    close(np.concatenate([g["dw"] for g in got], -1), wt.grad.numpy(),
          NORM_REL)


def check_launchers(arch, serve=True):
    """The smoke arch under RANK / WORLD_SIZE on a (data=2, model=1) mesh
    against one process: the train loop's step-0 loss to the printed 4
    decimals (FSDP, each rank its rows) and, with ``serve``, the engine's
    sample tokens (the slots split over the ranks)."""
    train = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
             "--batch", "4", "--seq", "16"]
    two, one = (_launch("repro_torch.launch.train", train, w)
                for w in (2, 0))
    for rc, _, err in two + one:
        assert rc == 0, err[-2000:]
    loss = re.compile(r"step +0 loss ([0-9.]+)")
    assert loss.search(two[0][1]).group(1) == loss.search(one[0][1]).group(1)
    assert "[train] done" in two[0][1] and two[1][1] == ""
    if not serve:
        return
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
            "--slots", "4", "--prompt-len", "8", "--gen", "4"]
    two, one = (_launch("repro_torch.launch.serve", args, w) for w in (2, 0))
    for rc, _, err in two + one:
        assert rc == 0, err[-2000:]
    sample = re.compile(r"sample token ids: (.*)")
    assert sample.search(two[0][1]).group(1) == sample.search(
        one[0][1]).group(1)
    assert "4 requests x 4 tokens" in two[0][1] and two[1][1] == ""


def test_launchers_run_rwkv6_on_two_ranks():
    check_launchers(ARCH)
