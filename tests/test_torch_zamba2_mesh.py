"""zamba2 on the port's (pod, data, model) mesh over gloo ranks on the CPU
(tests/torch_family_mesh_ranks.py holds the rank sides), against the JAX
package jitted on a host mesh of the same shape (Auto axes) and the port
on one rank, as tests/test_torch_rwkv6_mesh.py holds rwkv6:

  * the forward on (1, 1, 2) (the smoke config's 2 SSD heads and 4
    attention heads split 1 and 2 a rank; the fused ``in_proj``'s 274
    columns 137 a rank, cutting its segments) and (1, 1, 4) (the mixed
    layout: ``in_proj`` whole and the 2 SSD heads run whole on every
    rank, ``out_proj`` and ``gate_norm`` split; the shared block's 4
    heads one a rank): f32 logits within MODEL_REL max|logit| of one
    rank's and of the reference's (the whole model's bar of
    tests/test_torch_zamba2.py, 5e-5: f32 sums in other orders compound
    over the 7 layers; measured 1.6e-5 from one rank on 2 ranks, 1.2e-5
    on 4, where one Mamba2 layer alone holds 1e-5), the same on every
    rank; bf16 within 1.5 times the one-rank bf16 forward's distance from
    f32;
  * serving on both meshes: engine, naive-loop and ``drive`` tokens equal
    one rank's; a chain of 20 ``serve_fn`` steps past the window of 16
    (the KV rings wrap): the state gathered whole within 1e-5 of its max
    from one rank's; the pool's blocks;
  * training on (1, 2, 2), FSDP + TP, with and without gather_once: loss
    within 1e-6 relative, every gathered gradient leaf within 1e-4 max|g|
    of the reference's value_and_grad on a (1, 2, 2) host mesh and of one
    rank;
  * the compressed step on (2, 1, 2): each pod's whole-leaf gradient
    within 1e-4 max|g| of the reference's on its rows, the summed words
    the same on every rank, the params bitwise equal across pods;
  * one Mamba2 layer alone on 2 and 4 ranks (``in_proj``'s columns
    regrouped by heads; at d_model 128 on 4 ranks its 532 columns cut
    into 133 a rank with the 4 heads split; the smoke layer on 4 ranks
    mixed; a state of 1 on 4 ranks, in_proj split and the heads whole):
    output, decode step and every gradient, those of the replicated
    per-head ``A_log``, ``D`` and ``dt_bias`` included, within 1e-5 of
    the whole layer's;
  * both launchers under RANK / WORLD_SIZE on 2 CPU processes: the single
    process's step-0 loss and sample tokens.

The smoke config in f32, A_log and dt_bias drawn nonzero
(``test_torch_zamba2._params``), one torch thread per rank."""
import numpy as np
import pytest
import torch

import torch_family_mesh_ranks as fr
import torch_mesh_ranks as mr
from repro_torch.models import mamba2, registry
from test_torch_mesh_train import FUSED, _by_pod
from test_torch_moe_mesh_pods import POD_SEED, POD_STEPS
from test_torch_rwkv6_mesh import (GRAD_REL, N_GEN, SERVE, _one_torch_thread,
                                   cfgs, check_forward, check_launchers,
                                   check_params_across_pods, check_serve,
                                   check_train, close, one_rank_grads,
                                   one_rank_serve, ref_loss_and_grads,
                                   requests_of, spawn)
from test_torch_zamba2 import MODEL_REL, _np, _params

ARCH = "zamba2-7b"
BLOCK_REL = 1e-5
# (name, ranks, config overrides): the smoke layer on 2 ranks (heads and
# in_proj split), at d_model 128 on 4 (4 heads split, in_proj's 532
# columns cut 133 a rank), the smoke layer on 4 (mixed: in_proj whole,
# heads whole, out_proj and gate_norm split), and with a state of 1 on 4
# (in_proj's 260 columns cut 65 a rank while the 2 heads run whole on
# every rank: the product gathered with ``parallel.gather_whole``)
BLOCK_CASES = (("smoke2", 2, {}), ("d128x4", 4, {"d_model": 128}),
               ("mixed4", 4, {}), ("state1x4", 4, {"ssm_state": 1}))

__all__ = ["_one_torch_thread"]


def block_inputs(cfg, seed=12):
    """One Mamba2 layer's leaves (A_log, dt_bias off their zero init), x
    (2, 16, d), the cotangent and a decode state."""
    rng = np.random.default_rng(seed)
    H, P, N = mamba2.heads(cfg)
    p = {}
    for k, s in mamba2.mamba2_specs(cfg).items():
        if k in ("A_log", "dt_bias"):
            x = 0.5 * rng.standard_normal(s.shape)
        elif s.init == "ones":
            x = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            x = rng.standard_normal(s.shape) / np.sqrt(max(s.shape[0], 1))
        p[k] = x.astype(np.float32)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    state = (0.3 * rng.standard_normal((2, H, P, N))).astype(np.float32)
    return p, x, c, state


def block_cfg(kw):
    return mr._cfg(ARCH).scaled(**kw)


@pytest.fixture(scope="module")
def ran():
    cfg_j, cfg = cfgs(ARCH)
    params = _np(_params(cfg_j, seed=1))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, size=(2, 16), dtype=np.int32)
    train = rng.integers(0, cfg.vocab, size=(4, 16), dtype=np.int32)
    prompts = rng.integers(0, cfg.vocab, size=(4, 6), dtype=np.int32)
    chain = rng.integers(0, cfg.vocab, size=(2, 20), dtype=np.int32)
    requests = requests_of(cfg, 5, 6, seed=4)
    fam = "torch_family_mesh_ranks"
    blocks = {name: block_inputs(block_cfg(kw))
              for name, _, kw in BLOCK_CASES}

    def serve_jobs(shape):
        return [(fam, "forward_side", (shape, ARCH, params, tokens)),
                (fam, "serve_side", (shape, ARCH, params, prompts, N_GEN,
                                     requests, chain))] + [
            (fam, "mamba_side", (kw,) + blocks[name])
            for name, n, kw in BLOCK_CASES if n == shape[2]]

    train_args = (ARCH, params, train)
    four, two = spawn(serve_jobs((1, 1, 4)) + [
        ("torch_mesh_ranks", "train_side", ((1, 2, 2),) + train_args + (
            None, 2, once, 1, 0, None, "sgd")) for once in (False, True)] + [
        ("torch_mesh_ranks", "train_side", ((2, 1, 2),) + train_args + (
            FUSED, 1, False, POD_STEPS, POD_SEED, None))],
        serve_jobs((1, 1, 2)))
    return {"cfg": cfg, "cfg_j": cfg_j, "params": params, "tokens": tokens,
            "train": train, "prompts": prompts, "chain": chain,
            "requests": requests, "blocks": blocks,
            "forward": {(1, 1, 4): four[0], (1, 1, 2): two[0]},
            "serve": {(1, 1, 4): four[1], (1, 1, 2): two[1]},
            "block_ranks": {"smoke2": two[2], "d128x4": four[2],
                            "mixed4": four[3], "state1x4": four[4]},
            "fsdp": four[5], "fsdp_once": four[6], "pods": four[7]}


@pytest.fixture(scope="module")
def one(ran):
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


@pytest.mark.parametrize("shape", SERVE, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_reference_and_one_rank(ran, one, shape):
    """f32 within MODEL_REL of one rank's and of the reference's; the
    local blocks: on 2 ranks in_proj split (137 columns), on 4 the
    mixed layout (in_proj whole, out_proj and gate_norm split)."""
    check_forward(ran, one, shape, rel=MODEL_REL)
    cfg, n = ran["cfg"], shape[2]
    H, P, N = mamba2.heads(cfg)
    d_in = H * P
    cols = 2 * d_in + 2 * N + H
    local = ran["forward"][shape][0]["local_shapes"]
    in_cols = cols // n if cols % n == 0 else cols
    assert local["groups.0.0.in_proj"] == (cfg.d_model, in_cols)
    assert local["groups.0.0.out_proj"] == (d_in // n, cfg.d_model)
    assert local["groups.0.0.gate_norm"] == (d_in // n,)
    assert local["groups.0.0.A_log"] == (H,)
    assert local["shared_attn.attn.wq"] == (cfg.d_model, cfg.d_model // n)
    assert (n == 4) == (in_cols == cols)


@pytest.mark.parametrize("shape", SERVE, ids=lambda s: "x".join(map(str, s)))
def test_serving_matches_one_rank(ran, one, shape):
    """Tokens equal one rank's; the state after 20 steps past the window
    within 1e-5; the pool: SSD states by heads where they divide (on 4
    ranks the 2 heads stay whole), KV rings by heads, kv_pos and pos
    whole over model."""
    check_serve(ran, one, shape)
    cfg, n = ran["cfg"], shape[2]
    H, P, N = mamba2.heads(cfg)
    pool = ran["serve"][shape][0]["pool"]
    h = H // n if H % n == 0 else H
    assert pool["ssm_tail"][1:] == (4, h, P, N)
    assert pool["attn_k"][1] == 4 and pool["attn_k"][3] == cfg.n_kv_heads // n
    assert pool["kv_pos"][0] == pool["pos"][0] == 4


@pytest.mark.parametrize("variant", ["fsdp", "fsdp_once"])
def test_fsdp_tp_loss_and_gradient(ran, one, variant):
    check_train(ran, one, variant, ran["cfg_j"], {"tokens": ran["train"]})


def test_compressed_pods(ran):
    """(2, 1, 2): each pod's first-step whole-leaf gradient within 1e-4
    max|g| of the reference's on its rows; every rank sums the same
    words; params bitwise equal across pods."""
    ranks = ran["pods"]
    by_pod = _by_pod(ranks)
    for c, t in enumerate(np.split(ran["train"], 2)):
        want = ref_loss_and_grads(ran["cfg_j"], ran["params"],
                                  {"tokens": t}, (1, 1, 2), 1)[1]
        got = by_pod[c][0]["records"][0]["grads"]
        assert len(got) == len(want)
        for a, w in zip(got, want):
            close(a, w, GRAD_REL)
    for g in ranks:
        for a, b in zip(g["records"][0]["words"],
                        ranks[0]["records"][0]["words"]):
            np.testing.assert_array_equal(a, b)
    check_params_across_pods(ranks)


def _whole_block(cfg, p, x, c, state):
    lp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = mamba2.mamba2_block(cfg, type("L", (), lp), xt)
    (y * torch.from_numpy(c)).sum().backward()
    with torch.no_grad():
        yd, s = mamba2.mamba2_decode(cfg, type("L", (), lp), xt[:, :1],
                                     torch.from_numpy(state))
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "grads": {k: np.zeros(t.shape, np.float32) if t.grad is None
                      else t.grad.numpy() for k, t in lp.items()},
            "decode_y": yd.numpy(), "decode_state": s.numpy()}


@pytest.mark.parametrize("name", [c[0] for c in BLOCK_CASES])
def test_mamba2_layer_on_the_model_axis(ran, name):
    """One Mamba2 layer on n ranks against the whole layer: y, dx, the
    decode step and every leaf's gradient within 1e-5 of their max (the
    replicated A_log / D / dt_bias summed over model); each case holds
    the layout its docstring names."""
    n, kw = next((c[1], c[2]) for c in BLOCK_CASES if c[0] == name)
    cfg = block_cfg(kw)
    want = _whole_block(cfg, *ran["blocks"][name])
    ranks = ran["block_ranks"][name]
    for g in ranks:
        for key in ("y", "dx", "decode_y", "decode_state"):
            close(g[key], want[key], BLOCK_REL)
        for k, w in want["grads"].items():
            if k == "norm_w":  # never read, as in the reference
                assert not w.any() and not g["grads"][k].any()
                continue
            close(g["grads"][k], w, BLOCK_REL)
    H, P, N = mamba2.heads(cfg)
    cols = 2 * H * P + 2 * N + H
    local = ranks[0]["local_shapes"]
    split_in = name != "mixed4"
    assert local["in_proj"][1] == (cols // n if split_in else cols)
    assert (H % n == 0) == (name in ("smoke2", "d128x4"))
    assert local["out_proj"][0] == H * P // n


def test_launchers_run_zamba2_on_two_ranks():
    check_launchers(ARCH)
