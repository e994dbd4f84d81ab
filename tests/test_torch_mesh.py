"""The port's (pod, data, model) mesh over gloo ranks on the CPU
(tests/torch_ranks.py spawns them; tests/torch_mesh_ranks.py holds the
rank sides), against the port on one rank and the JAX package:

  * tensor parallel on (1, 1, 2) (qwen1.5-0.5b smoke: 4 heads over 2) and
    (1, 1, 4) (starcoder2-3b smoke, 2 KV heads of 16: each rank's 8
    columns of wk / wv cut a head): logits within 1e-5 max|logit| of the
    one-rank port and of the reference's forward, bitwise equal across
    the model ranks;
  * serving: the f32 engine's tokens equal the one-rank engine's and the
    naive loop's; on (1, 1, 4) the KV cache splits the sequence over the
    ranks, and decode attention on the split cache is within 1e-6 of the
    whole one; the vocab-sharded argmax takes the lower index on a tie
    across a block boundary;
  * ``nn.row_parallel`` in bf16 rounds the sum of the ranks' partials
    once; the bf16 forward on (1, 1, 2) and (1, 1, 4) stays as close to
    the f32 logits as the one-rank bf16 forward;
  * the collectives of ``dist.collectives``, exact, with their gradients.

Training and checkpoints on the mesh: tests/test_torch_mesh_train.py; the
launchers under RANK / WORLD_SIZE: tests/test_torch_mesh_launch.py.

The smoke configs run in f32 with their zero / one initialised leaves
(biases, norms) drawn away from 0 and 1, one torch thread per rank."""
import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as mr
import torch_ranks
from repro import configs as jconfigs
from repro.dist import meshctx as jmeshctx
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.convert import transformer_from_numpy
from repro_torch.launch import serve as launch
from repro_torch.models import attention, transformer
from repro_torch.serve import ServeEngine, naive_generate

LOGIT_REL = 1e-5
DECODE_ATOL = 1e-6
BF16_FACTOR = 1.5
ROUNDED_ONCE = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, kv_heads=None):
    cfg_j = jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32")
    cfg = mr._cfg(arch, kv_heads)
    if kv_heads is not None:
        cfg_j = cfg_j.scaled(n_kv_heads=kv_heads)
    return cfg_j, cfg


def _params(cfg_j, seed=0):
    """The reference's init, its constant leaves drawn nonzero: a numpy
    tree (layer stacks on a leading axis)."""
    specs = jregistry.param_specs(cfg_j)
    params = jax.tree.map(np.asarray,
                          jnn.init_params(specs, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def fix(p, s):
        if s.init in ("zeros", "ones"):
            return (p + 0.1 * rng.standard_normal(p.shape)).astype(p.dtype)
        return p

    return jax.tree.map(fix, params, specs, is_leaf=jnn.is_spec)


def _ref_logits(cfg_j, params, tokens):
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])
    prev = jmeshctx._mesh
    jmeshctx._mesh = mesh
    try:
        return np.asarray(jregistry.logits_fn(
            cfg_j, params, {"tokens": jax.numpy.asarray(tokens)}))
    finally:
        jmeshctx._mesh = prev


def _requests(cfg, n, p, seed):
    rng = np.random.default_rng(seed)
    return [(r, rng.integers(0, cfg.vocab, size=(int(rng.integers(2, p + 1)),),
                             dtype=np.int32), 6 if r % 2 else 3)
            for r in range(n)]


SERVE_CASES = {
    # (mesh, arch, kv heads): qwen's 4 heads split 2 / 2, its KV heads too;
    # starcoder2's 2 KV heads of 16 over 4 ranks cut a head each
    "tp2": ((1, 1, 2), "qwen1.5-0.5b", None),
    "tp4_cut": ((1, 1, 4), "starcoder2-3b", 2),
}
N_GEN = 8  # the pool's 8 + 8 rows split over 4 ranks


@pytest.fixture(scope="module")
def served():
    out = {}
    for name, (shape, arch, kv) in SERVE_CASES.items():
        cfg_j, cfg = _cfgs(arch, kv)
        params = _params(cfg_j)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab, size=(2, 12), dtype=np.int32)
        prompts = rng.integers(0, cfg.vocab, size=(4, 8), dtype=np.int32)
        requests = _requests(cfg, 5, 8, seed=4)
        got = torch_ranks.run_ranks(mr.serve_side, 4 if shape[2] == 4 else 2,
                                    shape, arch, kv, params, tokens, prompts,
                                    N_GEN, requests)
        model = transformer_from_numpy(cfg, params, "cpu")
        bf16 = cfg.scaled(compute_dtype="bfloat16")
        with torch.no_grad():
            one, _ = transformer.forward(cfg, model, torch.from_numpy(tokens))
            one_bf16, _ = transformer.forward(bf16, model,
                                              torch.from_numpy(tokens))
        engine = ServeEngine(cfg, max_slots=4, max_prefill_len=8,
                             max_gen_len=N_GEN, device="cpu")
        drive_one, _ = launch.drive(
            ServeEngine(cfg, max_slots=2, max_prefill_len=8,
                        max_gen_len=N_GEN, device="cpu"), model, requests)
        out[name] = {
            "ranks": got, "one": one.numpy(),
            "one_bf16": one_bf16.to(torch.float32).numpy(),
            "ref": _ref_logits(cfg_j, params, tokens),
            "engine": mr._engine_tokens(engine, model, prompts, N_GEN),
            "engine_rep": mr._engine_tokens(
                ServeEngine(cfg, max_slots=4, max_prefill_len=8,
                            max_gen_len=N_GEN - 1, device="cpu"),
                model, prompts, N_GEN - 1),
            "naive": naive_generate(cfg, model,
                                    {"tokens": torch.from_numpy(prompts)},
                                    N_GEN).numpy(),
            "drive": drive_one, "cfg": cfg}
    return out


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_tensor_parallel_forward(served, case):
    """Logits within 1e-5 max|logit| of the one-rank port and of the
    reference, and bitwise equal on every model rank."""
    r = served[case]
    scale = float(np.abs(r["one"]).max())
    for g in r["ranks"]:
        np.testing.assert_array_equal(g["logits"], r["ranks"][0]["logits"])
    got = r["ranks"][0]["logits"]
    assert got.shape == r["one"].shape
    assert np.abs(got - r["one"]).max() <= LOGIT_REL * scale
    assert np.abs(got - r["ref"]).max() <= LOGIT_REL * scale


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_tensor_parallel_forward_bf16(served, case):
    """The bf16 forward on the mesh: its logits no further from the f32
    logits than BF16_FACTOR times the one-rank bf16 forward's distance
    (measured: the same bits as the one-rank forward's in every draw
    tried), and bitwise equal on every model rank."""
    r = served[case]
    for g in r["ranks"]:
        np.testing.assert_array_equal(g["logits_bf16"],
                                      r["ranks"][0]["logits_bf16"])
    got = r["ranks"][0]["logits_bf16"]
    one_err = float(np.abs(r["one_bf16"] - r["one"]).max())
    assert 0.0 < one_err
    assert float(np.abs(got - r["one"]).max()) <= BF16_FACTOR * one_err


@pytest.mark.parametrize("n", [2, 4])
def test_row_parallel_rounds_once(n):
    """``nn.row_parallel`` in bf16 over n ranks, each holding a block of
    the 512-deep sum: at least ROUNDED_ONCE of its outputs are the exact
    product rounded once to bf16 (measured: all; with each rank's partial
    rounded to bf16 before the sum, 61-63%), the same bits on every
    rank."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 512)).astype(np.float32)
    w = (rng.standard_normal((512, 64)) / np.sqrt(512)).astype(np.float32)
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    got = torch_ranks.run_ranks(mr.row_parallel_side, n,
                                x.float().numpy(), w.float().numpy())
    want = (x.double() @ w.double()).to(torch.float32).to(
        torch.bfloat16).float().numpy()
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    assert float((got[0] == want).mean()) >= ROUNDED_ONCE


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_engine_and_naive_loop_tokens(served, case):
    """The f32 engine at full occupancy, the naive loop and the drive loop
    over staggered requests give the one-rank port's tokens on every
    rank."""
    r = served[case]
    for g in r["ranks"]:
        np.testing.assert_array_equal(g["engine"], r["engine"])
        np.testing.assert_array_equal(g["engine_rep"], r["engine_rep"])
        np.testing.assert_array_equal(g["naive"], r["naive"])
        assert g["drive"] == r["drive"]
    np.testing.assert_array_equal(r["engine"], r["naive"])


def test_cache_layouts(served):
    """Where the KV heads split, each rank's prefill cache and pool hold
    its own; where they do not (the cut heads), all of them, and the pool
    of 16 rows splits the sequence, 4 rows a rank (``engine_rep``'s 15
    rows do not split: the pool is replicated)."""
    cfg2, cfg4 = served["tp2"]["cfg"], served["tp4_cut"]["cfg"]
    g2, g4 = served["tp2"]["ranks"][0], served["tp4_cut"]["ranks"][0]
    assert g2["cache_heads"] == cfg2.n_kv_heads // 2 and not g2["seq_split"]
    assert g2["cache_shape"][3] == cfg2.n_kv_heads // 2
    assert g4["cache_heads"] == cfg4.n_kv_heads and g4["seq_split"]
    assert g4["cache_shape"] == (cfg4.n_layers, 4, (8 + N_GEN) // 4,
                                 cfg4.n_kv_heads, cfg4.hd)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_on_a_split_sequence(window):
    """decode_attention over 4 ranks' rows, the softmax combined across
    them, within 1e-6 of the whole cache's, slots at several depths."""
    rng = np.random.default_rng(5)
    B, S, HQ, HK, D = 3, 16, 4, 2, 16
    q = rng.standard_normal((B, 1, HQ, D), dtype=np.float32)
    kc = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    vc = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    nk = rng.standard_normal((B, 1, HK, D), dtype=np.float32)
    nv = rng.standard_normal((B, 1, HK, D), dtype=np.float32)
    valid = np.array([3, 9, 16], dtype=np.int64)
    t = torch.from_numpy
    want = attention.decode_attention(t(q), t(kc), t(vc), t(nk), t(nv),
                                      valid_len=t(valid), window=window)
    got = torch_ranks.run_ranks(mr.decode_attention_side, 4, q, kc, vc, nk,
                                nv, valid, window)
    for g in got:
        assert np.abs(g - want.numpy()).max() <= DECODE_ATOL


def test_vocab_argmax_ties_take_the_lower_index():
    """Row 0: equal maxima at the last index of block 0 and the first of
    block 1; row 1: in blocks 1 and 2; row 2: one maximum in block 3."""
    V = 4 * 8
    logits = np.zeros((3, V), dtype=np.float32)
    logits[0, [7, 8]] = 2.0
    logits[1, [12, 20]] = 3.0
    logits[2, 30] = 1.0
    got = torch_ranks.run_ranks(mr.argmax_side, 4, logits, V)
    want = np.argmax(logits, axis=-1)
    np.testing.assert_array_equal(want, [7, 12, 30])
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_collectives_exact_and_their_gradients():
    """On 4 ranks: the gather concatenates the blocks bit for bit in f32,
    bf16, int32 and int64; the bf16 all-reduce is the sum rounded once; the
    reduce-scatter and max; gather's gradient is the reduce-scatter of
    the ranks' weights, copy_to's the all-reduce, reduce_from's the
    identity."""
    rng = np.random.default_rng(8)
    n = 4
    blocks = rng.integers(-60, 60, size=(n, 4, 3)).astype(np.float32)
    weights = rng.integers(-5, 5, size=(n, 4, 3 * n)).astype(np.float32)
    got = torch_ranks.run_ranks(mr.collectives_side, n, blocks, weights)
    cat = np.concatenate(list(blocks), axis=1)
    total = blocks.sum(axis=0)
    bf16_total = torch.from_numpy(total).to(torch.bfloat16).to(
        torch.float64).numpy()
    wsum = weights.sum(axis=0)
    for r, g in enumerate(got):
        for name, (dtype, x) in g["gather"].items():
            np.testing.assert_array_equal(x, cat)
        assert [d for d, _ in g["gather"].values()] == [
            "torch.float32", "torch.bfloat16", "torch.int32", "torch.int64"]
        assert g["sum_bf16"][0] == "torch.bfloat16"
        np.testing.assert_array_equal(g["sum_bf16"][1], bf16_total)
        np.testing.assert_array_equal(g["reduce_scatter"], total[r:r + 1])
        np.testing.assert_array_equal(g["max"], blocks.max(axis=0))
        np.testing.assert_array_equal(g["grad_gather"],
                                      wsum[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(g["grad_copy_to"], wsum[:, :3])
        np.testing.assert_array_equal(g["reduce_from"], total)
        np.testing.assert_array_equal(g["grad_reduce_from"],
                                      weights[r][:, :3])
