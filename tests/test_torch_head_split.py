"""Query heads cut by the model axis: the reference's layout where ``wq``'s
column blocks split heads (starcoder2-3b's and minitron-4b's 24 heads and
whisper-small's 12 over a model axis of 16).  Smoke configs scaled to 6
query heads of 16 on (1, 1, 4), so 1.5 heads fall to a rank: a dense one
with 2 KV heads (each rank's 8 columns of ``wk`` / ``wv`` cut a KV head
too) and whisper's with 6 (its self- and cross-attention).  Each rank
projects with its column blocks of wq / wk / wv, gathers q, k and v whole
in one collective, runs attention over all heads and takes its column
block of the output into the row-parallel ``wo``.  Held against the JAX
package jitted on a (1, 1, 4) host mesh (Auto axes) and the port on one
rank (tests/torch_head_split_ranks.py holds the rank sides):

  * the f32 forward within 1e-5 max|logit| of the reference's and of one
    rank's, the same on every rank;
  * serving in f32: the engine's tokens at full occupancy (its pool split
    over the sequence), the naive loop's, the drive loop's and a
    ``serve_fn`` chain's (a step on a cache split over the sequence
    wherever its rows divide the axis) equal one rank's; whisper's
    ``serve_fn`` chain the same;
  * training on (1, 1, 4), f32: the loss within 1e-6 relative and every
    gathered gradient leaf within 1e-4 max|g| of the reference's jitted
    ``value_and_grad`` and of one rank's;
  * a cut head's ``wo`` product in bf16 rounds once, after the f32 sum.

One torch thread per rank."""
import numpy as np
import pytest
import torch

import torch_head_split_ranks as hr
import torch_mesh_ranks as mr
import torch_moe_mesh_ranks as mmr
import torch_ranks
from repro import configs as jconfigs
from repro_torch.launch import serve as launch
from repro_torch.models import registry
from repro_torch.serve import ServeEngine, naive_generate
from test_torch_mesh import ROUNDED_ONCE, _requests
from test_torch_mesh import _params as dense_params
from test_torch_rwkv6_mesh import (GRAD_REL, LOGIT_REL, LOSS_REL,
                                   _one_torch_thread, close, one_rank_grads,
                                   ref_logits, ref_loss_and_grads)
from test_torch_whisper import _frames, _np
from test_torch_whisper import _params as whisper_params

__all__ = ["_one_torch_thread"]

SHAPE = (1, 1, 4)
HEADS = {"dense": ("qwen1.5-0.5b", dict(n_heads=6, n_kv_heads=2,
                                        head_dim=16)),
         "whisper": ("whisper-small", dict(n_heads=6, n_kv_heads=6,
                                           head_dim=16))}
N_GEN = 8    # the pool's 8 + 8 rows split over the 4 ranks
N_STEPS = 6  # serve_fn chain steps


def cfgs(kind):
    arch, kw = HEADS[kind]
    return (jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32",
                                                   **kw),
            hr.head_cfg(arch, kw))


@pytest.fixture(scope="module")
def ran():
    rng = np.random.default_rng(6)
    out = {}
    jobs = []
    for kind, (arch, kw) in HEADS.items():
        cfg_j, cfg = cfgs(kind)
        if kind == "dense":
            params = dense_params(cfg_j, seed=1)
            batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 12),
                                            dtype=np.int32)}
            train = {"tokens": rng.integers(0, cfg.vocab, size=(4, 12),
                                            dtype=np.int32)}
            prompts = rng.integers(0, cfg.vocab, size=(4, 8), dtype=np.int32)
            requests = _requests(cfg, 5, 8, seed=4)
            chain = rng.integers(0, cfg.vocab, size=(2, 9), dtype=np.int32)
            jobs.append(("torch_head_split_ranks", "dense_side", (
                SHAPE, arch, kw, params, batch["tokens"], prompts, N_GEN,
                requests, chain, N_STEPS)))
            out[kind] = {"prompts": prompts, "requests": requests,
                         "chain": chain}
        else:
            params = _np(whisper_params(cfg_j, seed=1))
            batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 12),
                                            dtype=np.int32),
                     "frames": _frames(cfg, 2, seed=7)}
            train = {"tokens": rng.integers(0, cfg.vocab, size=(4, 12),
                                            dtype=np.int32),
                     "frames": _frames(cfg, 4, seed=8)}
            prompt = rng.integers(0, cfg.vocab, size=(2, 5), dtype=np.int32)
            jobs.append(("torch_head_split_ranks", "whisper_side", (
                SHAPE, arch, kw, params, batch["tokens"], batch["frames"],
                prompt, N_STEPS)))
            out[kind] = {"prompt": prompt}
        out[kind].update(cfg=cfg, cfg_j=cfg_j, params=params, batch=batch,
                         train=train)
    for kind, (arch, kw) in HEADS.items():
        r = out[kind]
        jobs.append(("torch_mesh_ranks", "train_side", (
            SHAPE, arch, r["params"], r["train"]["tokens"], None, 2, False,
            0, 0, None, "sgd", kw, r["train"].get("frames"))))
    got = torch_ranks.run_ranks(mmr.jobs_side, SHAPE[2], jobs)
    for i, kind in enumerate(HEADS):
        out[kind]["serve"] = [g[i] for g in got]
        out[kind]["grads"] = [g[len(HEADS) + i] for g in got]
    return out


@pytest.fixture(scope="module")
def one(ran):
    """The one-rank port on the fixture's inputs."""
    from torch_family_mesh_ranks import whisper_chain

    out = {}
    for kind, r in ran.items():
        cfg = r["cfg"]
        model = hr._model(cfg, r["params"], None)
        batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
        o = {}
        with torch.no_grad():
            o["logits"] = registry.logits_fn(cfg, model, batch).numpy()
            if kind == "dense":
                o["chain"], _ = hr.serve_chain(cfg, model, None, r["chain"],
                                               N_STEPS)
            else:
                toks, chain, _ = whisper_chain(
                    cfg, model, torch.from_numpy(r["prompt"]),
                    batch["frames"], N_STEPS)
                o["tokens"], o["chain_logits"] = toks.numpy(), chain.numpy()
        if kind == "dense":
            P = r["prompts"].shape[1]
            o["engine"] = mr._engine_tokens(
                ServeEngine(cfg, max_slots=4, max_prefill_len=P,
                            max_gen_len=N_GEN, device="cpu"), model,
                r["prompts"], N_GEN)
            o["naive"] = naive_generate(
                cfg, model, {"tokens": torch.from_numpy(r["prompts"])},
                N_GEN).numpy()
            o["drive"], _ = launch.drive(
                ServeEngine(cfg, max_slots=2, max_prefill_len=P,
                            max_gen_len=N_GEN, device="cpu"), model,
                r["requests"])
        o["loss"], o["grads"] = one_rank_grads(cfg, r["params"], r["train"],
                                               2)
        out[kind] = o
    return out


@pytest.mark.parametrize("kind", sorted(HEADS))
def test_forward_matches_reference_and_one_rank(ran, one, kind):
    """f32 logits within 1e-5 max|logit| of the reference's on a (1, 1, 4)
    host mesh and of one rank's, the same bits on every rank; each rank
    holds 24 of wq's 96 columns (1.5 heads) and 24 rows of wo."""
    r = ran[kind]
    ranks = r["serve"]
    for g in ranks:
        np.testing.assert_array_equal(g["logits"], ranks[0]["logits"])
    got = ranks[0]["logits"]
    close(got, one[kind]["logits"], LOGIT_REL)
    close(got, ref_logits(r["cfg_j"], r["params"], r["batch"], SHAPE),
          LOGIT_REL)
    cfg = r["cfg"]
    assert cfg.n_heads % SHAPE[2]
    if kind == "dense":
        cols = cfg.n_heads * cfg.hd // SHAPE[2]
        assert ranks[0]["local"]["wq"] == (cfg.d_model, cols)
        assert ranks[0]["local"]["wo"] == (cols, cfg.d_model)
        assert ranks[0]["local"]["wk"] == (
            cfg.d_model, cfg.n_kv_heads * cfg.hd // SHAPE[2])


def test_dense_serving_matches_one_rank(ran, one):
    """The engine (its pool split over the sequence), the naive loop, the
    drive loop and a serve_fn chain over a cache split over the sequence
    where its rows divide the axis: f32 tokens one rank's on every
    rank."""
    r, o = ran["dense"], one["dense"]
    for g in r["serve"]:
        assert g["seq_split"]
        np.testing.assert_array_equal(g["engine"], o["engine"])
        np.testing.assert_array_equal(g["naive"], o["naive"])
        assert g["drive"] == o["drive"]
        np.testing.assert_array_equal(g["chain"], o["chain"])
        assert any(g["chain_split"]) and not all(g["chain_split"])
    np.testing.assert_array_equal(o["engine"], o["naive"])


def test_whisper_serving_matches_one_rank(ran, one):
    """whisper's serve_fn chain: tokens one rank's, logits within 1e-5;
    its self and cross caches hold all heads (the cut heads are run whole
    on every rank)."""
    r, o = ran["whisper"], one["whisper"]
    cfg = r["cfg"]
    for g in r["serve"]:
        np.testing.assert_array_equal(g["tokens"], o["tokens"])
        close(g["chain"], o["chain_logits"], LOGIT_REL)
        assert g["cache"]["cross_k"] == (cfg.n_layers, 2, cfg.encoder_len,
                                         cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("kind", sorted(HEADS))
def test_loss_and_gradient(ran, one, kind):
    """(1, 1, 4), f32, 2 microbatches: the loss within 1e-6 relative and
    every gathered gradient leaf within 1e-4 max|g| of the reference's
    jitted value_and_grad on a (1, 1, 4) host mesh and of one rank's;
    every rank gathers the same leaves."""
    r, o = ran[kind], one[kind]
    ranks = r["grads"]
    for g in ranks:
        for a, b in zip(g["grads"], ranks[0]["grads"]):
            np.testing.assert_array_equal(a, b)
    ref_loss, ref_grads = ref_loss_and_grads(r["cfg_j"], r["params"],
                                             r["train"], SHAPE, 2)
    g = ranks[0]
    for want_loss, want in ((ref_loss, ref_grads), (o["loss"], o["grads"])):
        assert abs(g["loss"] - want_loss) <= LOSS_REL * abs(want_loss)
        assert len(g["grads"]) == len(want)
        for got, w in zip(g["grads"], want):
            close(got, w, GRAD_REL)


def test_cut_head_wo_rounds_once():
    """``wo`` on 4 ranks, each holding 24 of its 96 rows (1.5 heads of
    16) and the matching column block of the bf16 attention output: at
    least ROUNDED_ONCE of the outputs are the exact product rounded once
    to bf16, the same bits on every rank."""
    rng = np.random.default_rng(9)
    o = rng.standard_normal((2, 16, 96)).astype(np.float32)
    wo = (rng.standard_normal((96, 64)) / np.sqrt(96)).astype(np.float32)
    o, wo = (torch.from_numpy(a).to(torch.bfloat16) for a in (o, wo))
    got = torch_ranks.run_ranks(hr.cut_wo_side, 4, o.float().numpy(),
                                wo.float().numpy())
    want = (o.double() @ wo.double()).to(torch.float32).to(
        torch.bfloat16).float().numpy()
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    assert float((got[0] == want).mean()) >= ROUNDED_ONCE
