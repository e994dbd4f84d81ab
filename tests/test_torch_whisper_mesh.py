"""whisper on the port's (pod, data, model) mesh over gloo ranks on the
CPU (tests/torch_family_mesh_ranks.py holds the rank sides), against the
JAX package jitted on a host mesh of the same shape (Auto axes) and the
port on one rank, as tests/test_torch_rwkv6_mesh.py holds rwkv6:

  * the forward over 8 frames and 12 tokens on (1, 1, 2) and (1, 1, 4)
    (the smoke config's 4 heads of 16: the encoder's, the decoder's self
    and cross attention on the rank's heads, each ``wo`` row-parallel;
    the tied unembedding the rank's vocab block): f32 logits within 1e-5
    max|logit| of the reference's and of one rank's, the same on every
    rank; bf16 within 1.5 times the one-rank bf16 forward's distance from
    f32;
  * the serving chain (the engine refuses whisper, as the reference's):
    ``prefill_fn``'s logits, then 6 greedy ``serve_fn`` steps over the
    rank's heads of the self and cross caches: tokens equal one rank's,
    logits within 1e-5;
  * training on (1, 2, 2), FSDP + TP (``enc_pos`` FSDP-gathered), with
    and without gather_once: loss within 1e-6 relative, every gathered
    gradient leaf within 1e-4 max|g| of the reference's value_and_grad on
    a (1, 2, 2) host mesh and of one rank;
  * the compressed step on (2, 1, 2): each pod's whole-leaf gradient
    within 1e-4 max|g| of the reference's on its rows, the summed words
    the same on every rank, the params bitwise equal across pods;
  * the train launcher under RANK / WORLD_SIZE on 2 CPU processes: the
    single process's step-0 loss (the serve launcher refuses whisper, as
    the reference's does).

The smoke config in f32, its zero / one leaves drawn off their init
(``test_torch_whisper._params``), one torch thread per rank."""
import numpy as np
import pytest
import torch

import torch_family_mesh_ranks as fr
from repro_torch.models import registry
from test_torch_mesh_train import FUSED, _by_pod
from test_torch_moe_mesh_pods import POD_SEED, POD_STEPS
from test_torch_rwkv6_mesh import (GRAD_REL, LOGIT_REL, SERVE,
                                   _one_torch_thread, cfgs, check_forward,
                                   check_launchers, check_params_across_pods,
                                   check_train, close, one_rank_grads,
                                   ref_loss_and_grads, spawn)
from test_torch_whisper import _frames, _np, _params

ARCH = "whisper-small"
N_STEPS = 6

__all__ = ["_one_torch_thread"]


@pytest.fixture(scope="module")
def ran():
    cfg_j, cfg = cfgs(ARCH)
    params = _np(_params(cfg_j, seed=1))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, size=(2, 12), dtype=np.int32)
    frames = _frames(cfg, 2, seed=7)
    train = rng.integers(0, cfg.vocab, size=(4, 12), dtype=np.int32)
    train_frames = _frames(cfg, 4, seed=8)
    prompt = rng.integers(0, cfg.vocab, size=(2, 5), dtype=np.int32)
    fam = "torch_family_mesh_ranks"

    def serve_jobs(shape):
        return [(fam, "forward_side", (shape, ARCH, params, tokens, frames)),
                (fam, "whisper_serve_side", (shape, ARCH, params, prompt,
                                             frames, N_STEPS))]

    train_args = (ARCH, params, train)
    four, two = spawn(serve_jobs((1, 1, 4)) + [
        ("torch_mesh_ranks", "train_side", ((1, 2, 2),) + train_args + (
            None, 2, once, 1, 0, None, "sgd", None, train_frames))
        for once in (False, True)] + [
        ("torch_mesh_ranks", "train_side", ((2, 1, 2),) + train_args + (
            FUSED, 1, False, POD_STEPS, POD_SEED, None, "adamw", None,
            train_frames))],
        serve_jobs((1, 1, 2)))
    return {"cfg": cfg, "cfg_j": cfg_j, "params": params, "tokens": tokens,
            "frames": frames, "train": train, "train_frames": train_frames,
            "prompt": prompt,
            "forward": {(1, 1, 4): four[0], (1, 1, 2): two[0]},
            "serve": {(1, 1, 4): four[1], (1, 1, 2): two[1]},
            "fsdp": four[2], "fsdp_once": four[3], "pods": four[4]}


@pytest.fixture(scope="module")
def one(ran):
    cfg = ran["cfg"]
    model = fr._model(cfg, ran["params"], None)
    bf16 = cfg.scaled(compute_dtype="bfloat16")
    batch = {"tokens": torch.from_numpy(ran["tokens"]),
             "frames": torch.from_numpy(ran["frames"])}
    t, f = torch.from_numpy(ran["prompt"]), torch.from_numpy(ran["frames"])
    with torch.no_grad():
        logits = registry.logits_fn(cfg, model, batch).numpy()
        logits_bf16 = registry.logits_fn(bf16, model, batch).to(
            torch.float32).numpy()
        last, _ = registry.prefill_fn(cfg)(model, {"tokens": t, "frames": f})
        toks, chain, _ = fr.whisper_chain(cfg, model, t, f, N_STEPS)
    out = {"logits": logits, "logits_bf16": logits_bf16,
           "prefill": last.numpy(), "tokens": toks.numpy(),
           "chain": chain.numpy()}
    out["loss"], out["grads"] = one_rank_grads(
        cfg, ran["params"], {"tokens": ran["train"],
                             "frames": ran["train_frames"]}, 2)
    return out


@pytest.mark.parametrize("shape", SERVE, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_reference_and_one_rank(ran, one, shape):
    """f32 within 1e-5 of the reference's and one rank's; the rank holds
    its heads' columns of every wq / wk / wv, rows of wo, its vocab block
    of the tied embedding."""
    check_forward(ran, one, shape)
    cfg, n = ran["cfg"], shape[2]
    d = cfg.d_model
    local = ran["forward"][shape][0]["local_shapes"]
    for stack in ("enc_layers.0.attn", "dec_layers.0.attn",
                  "dec_layers.0.cross"):
        assert local[f"{stack}.wq"] == (d, d // n)
        assert local[f"{stack}.wk"] == (d, d // n)
        assert local[f"{stack}.wo"] == (d // n, d)
    assert local["embed"] == (cfg.padded_vocab // n, d)
    assert local["enc_pos"] == (cfg.encoder_len, d)


@pytest.mark.parametrize("shape", SERVE, ids=lambda s: "x".join(map(str, s)))
def test_serving_chain_matches_one_rank(ran, one, shape):
    """``prefill_fn`` and a chain of greedy ``serve_fn`` steps: logits
    within 1e-5 of one rank's, tokens equal; the caches hold the rank's
    heads."""
    cfg, n = ran["cfg"], shape[2]
    for g in ran["serve"][shape]:
        assert g["prefill_cache"]
        close(g["prefill"], one["prefill"], LOGIT_REL)
        np.testing.assert_array_equal(g["tokens"], one["tokens"])
        close(g["logits"], one["chain"], LOGIT_REL)
        L, P = cfg.n_layers, ran["prompt"].shape[1]
        heads = cfg.n_kv_heads // n
        assert g["cache"]["k"] == (L, 2, P - 1 + N_STEPS, heads, cfg.hd)
        assert g["cache"]["cross_k"] == (L, 2, cfg.encoder_len, heads,
                                         cfg.hd)


@pytest.mark.parametrize("variant", ["fsdp", "fsdp_once"])
def test_fsdp_tp_loss_and_gradient(ran, one, variant):
    check_train(ran, one, variant, ran["cfg_j"],
                {"tokens": ran["train"], "frames": ran["train_frames"]})


def test_compressed_pods(ran):
    """(2, 1, 2): each pod's first-step whole-leaf gradient within 1e-4
    max|g| of the reference's on its rows and frames; every rank sums
    the same words; params bitwise equal across pods."""
    ranks = ran["pods"]
    by_pod = _by_pod(ranks)
    for c, (t, f) in enumerate(zip(np.split(ran["train"], 2),
                                   np.split(ran["train_frames"], 2))):
        want = ref_loss_and_grads(ran["cfg_j"], ran["params"],
                                  {"tokens": t, "frames": f}, (1, 1, 2),
                                  1)[1]
        got = by_pod[c][0]["records"][0]["grads"]
        assert len(got) == len(want)
        for a, w in zip(got, want):
            close(a, w, GRAD_REL)
    for g in ranks:
        for a, b in zip(g["records"][0]["words"],
                        ranks[0]["records"][0]["words"]):
            np.testing.assert_array_equal(a, b)
    check_params_across_pods(ranks)


def test_train_launcher_runs_whisper_on_two_ranks():
    check_launchers(ARCH, serve=False)
