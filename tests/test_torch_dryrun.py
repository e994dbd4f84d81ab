"""The port's dry run (``repro_torch.launch.dryrun``): rank 0's program of
every (architecture, shape) cell on the production meshes, (16, 16) and
(2, 16, 16), on meta tensors, over recording groups.

  * placement: every leaf's spec of every cell's inputs (params or train
    state, batch, decode state, under each rule table ``build_cell``
    picks) on both meshes equals the reference's ``PartitionSpec``, read
    from its own ``build_cell`` in a process of its own with 512 host
    devices (tests/dryrun_reference_specs.py); the reference's optimizer
    leaves mirror the first parameter of their shape, the port's their
    own parameter (``steps.train_state_shardings``), and both are held;
  * the recorder: on smoke cells, each collective kind's count and bytes
    on meta equal those counted at the ``torch.distributed`` boundary in a
    real gloo run of the same step (tests/torch_dryrun_ranks.py): a dense
    train step of 2 microbatches on (1, 2, 2), the 6-head decode on a
    cache split over the sequence on (1, 1, 4), the moe expert-parallel
    step on (1, 1, 2) and the compressed step on (2, 1, 2);
  * every cell of ``configs.cells()`` on both meshes, at the least depth
    that keeps each of its layer kinds, runs on meta with nonzero
    collective bytes;
  * the kernels' meta branches give their plain versions' outputs and
    saved tensors, in shape and dtype, and the flash backwards' scratch
    on meta is the size their C libraries ask for;
  * the memory tracker's peak on a hand-counted op sequence;
  * the CLI writes one cell's JSON with the reference's keys."""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dryrun_ranks as dr_ranks
import torch_moe_mesh_ranks as mmr
import torch_ranks
from repro_torch import configs
from repro_torch.dist import collectives as coll
from repro_torch.dist import meshctx, sharding
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = (False, True)

# the reference's record keys (repro/launch/dryrun.py, run_cell)
REF_KEYS = {"arch", "shape", "mesh", "compress", "lower_s", "compile_s",
            "flops", "bytes_accessed", "memory", "collective_bytes",
            "collective_counts"}
REF_MEMORY = {"temp_size_in_bytes", "argument_size_in_bytes",
              "output_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes"}


@pytest.fixture(autouse=True)
def _no_mesh_left():
    yield
    meshctx.set_mesh(None)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def reference_specs():
    got = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "dryrun_reference_specs.py")],
        capture_output=True, text=True, env=_env(), timeout=600, check=True)
    return json.loads(got.stdout)


def _norm(spec):
    """A spec as a list, trailing replicated dims dropped (the reference's
    PartitionSpec may be shorter than the tensor)."""
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _port_cell(arch, shape, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, abstract=True)
    _, args, shardings = dryrun.build_cell(arch, shape, mesh)
    specs = [_norm(ns.spec) for ns in sharding.tree_leaves(shardings)]
    shapes = [list(x.shape) if isinstance(x, torch.Tensor) else []
              for x in _sorted_leaves(args)]
    return args, specs, shapes


def _sorted_leaves(tree):
    """Leaves in the reference's pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


@pytest.mark.parametrize("multi_pod", MESHES, ids=("16x16", "2x16x16"))
def test_every_leaf_is_placed_as_the_reference(reference_specs, multi_pod):
    """Each cell's leaves, in pytree order: global shapes equal, specs
    equal the reference's; a train cell's optimizer leaves: the
    reference's the spec of the first parameter of their shape, the
    port's their own parameter's.  The cells are the reference's."""
    assert {f"{a}|{s}|{int(multi_pod)}" for a, s in configs.cells()} == {
        k for k in reference_specs if k.endswith(f"|{int(multi_pod)}")}
    for arch, shape in configs.cells():
        want = reference_specs[f"{arch}|{shape}|{int(multi_pod)}"]
        args, specs, shapes = _port_cell(arch, shape, multi_pod)
        ref_specs = [_norm(s) for s in want["specs"]]
        assert shapes == want["shapes"], (arch, shape)
        assert len(specs) == len(ref_specs), (arch, shape)
        if configs.SHAPES[shape]["step"] != "train":
            assert specs == ref_specs, (arch, shape)
            continue
        n_opt, n_par = want["n_opt"], want["n_params"]
        params = specs[n_opt:n_opt + n_par]
        assert params == ref_specs[n_opt:n_opt + n_par], (arch, shape)
        assert specs[n_opt + n_par:] == ref_specs[n_opt + n_par:]
        par_shapes = shapes[n_opt:n_opt + n_par]
        first = {}
        for s, sp in zip(par_shapes, params):
            first.setdefault(tuple(s), sp)
        mirrored = [first.get(tuple(s), []) for s in shapes[:n_opt]]
        assert ref_specs[:n_opt] == mirrored, (arch, shape)
        own = [params[i % n_par] for i in range(2 * n_par)] + [[]]
        assert specs[:n_opt] == own, (arch, shape)


# ------------------------------------------------------------- recorder
TRAIN = {"seq_len": 16, "global_batch": 8, "step": "train"}
DECODE = {"seq_len": 16, "global_batch": 4, "step": "decode"}
SIX = dict(n_heads=6, n_kv_heads=2, head_dim=16)
# name: (mesh, arch, cfg_kw, cell, compress, opts)
RECORDED = {
    "dense_train_accum2": ((1, 2, 2), "qwen1.5-0.5b", {}, TRAIN, "none",
                           {"accum": 2}),
    "six_head_decode": ((1, 1, 4), "qwen1.5-0.5b", SIX, DECODE, "none", {}),
    "compressed_pods": ((2, 1, 2), "qwen1.5-0.5b", {}, TRAIN, "irwin_hall",
                        {}),
    "moe_ep": ((1, 1, 2), "phi3.5-moe-42b-a6.6b", {}, dict(
        TRAIN, global_batch=4), "none", {"moe_ep": True}),
}


def _meta_record(shape, arch, cfg_kw, sh, compress, opts):
    rec = coll.new_record()
    mesh = meshctx.recording_mesh(shape, meshctx.AXES, rec)
    cfg = dr_ranks.smoke_cfg(arch, cfg_kw)
    fn, args, shardings = dryrun.build_step(cfg, sh, mesh, compress, opts)
    local = dryrun.place(args, shardings, "meta", dryrun.ROLES[sh["step"]])
    dryrun._run(fn, local, sh["step"] == "train")
    return rec


@pytest.fixture(scope="module")
def gloo_counts():
    four = [name for name, c in RECORDED.items() if np.prod(c[0]) == 4]
    two = [name for name, c in RECORDED.items() if np.prod(c[0]) == 2]
    out = {}
    for names, n in ((four, 4), (two, 2)):
        jobs = [("torch_dryrun_ranks", "count_side", RECORDED[k])
                for k in names]
        got = torch_ranks.run_ranks(mmr.jobs_side, n, jobs)
        for i, k in enumerate(names):
            out[k] = [g[i] for g in got]
    return out


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_recorder_matches_the_gloo_boundary(gloo_counts, name):
    """Counts and bytes by kind on meta equal rank 0's at the
    ``torch.distributed`` boundary (every rank issues the same), and the
    real step's outputs are finite."""
    ranks = gloo_counts[name]
    for g in ranks:
        assert g["record"] == ranks[0]["record"]
        assert g["finite"]
    got = _meta_record(*RECORDED[name])
    assert got == ranks[0]["record"]
    assert sum(got["counts"].values()) > 0
    assert got["counts"]["collective-permute"] == 0


# ----------------------------------------------------- every cell on meta
def _least_depth(cfg):
    """The fewest layers that keep each layer kind of ``cfg``: one, and
    for zamba2 one group of Mamba2 layers with the shared block and a
    Mamba2 tail layer."""
    if cfg.kind == "zamba2":
        return cfg.scaled(n_layers=cfg.shared_attn_every + 1)
    if cfg.kind == "whisper":
        return cfg.scaled(n_layers=1, encoder_layers=1)
    return cfg.scaled(n_layers=1)


CELLS = [(a, s, mp) for mp in MESHES for a, s in configs.cells()]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'mp' if mp else 'sp'}"
                              for a, s, mp in CELLS])
def test_every_cell_runs_on_meta(arch, shape, multi_pod):
    """The cell's step at the least depth on meta: nonzero collective
    bytes, the rank's arguments at its blocks' bytes, a peak above them."""
    rec = coll.new_record()
    mesh = make_production_mesh(multi_pod=multi_pod, record=rec)
    cfg = _least_depth(configs.get_config(arch))
    sh = configs.SHAPES[shape]
    fn, args, shardings = dryrun.build_step(
        cfg, sh, mesh, opts={"accum": dryrun._grad_accum(arch, shape)})
    local = dryrun.place(args, shardings, "meta", dryrun.ROLES[sh["step"]])
    got = dryrun.run_meta(fn, local, sh["step"] == "train")
    assert sum(rec["bytes"].values()) > 0
    mem = got["memory"]
    assert set(mem) == REF_MEMORY
    assert mem["argument_size_in_bytes"] == sum(
        t.numel() * t.element_size() for t in dryrun._leaves(local))
    assert mem["temp_size_in_bytes"] > 0 and got["flops"] > 0


# ------------------------------------------------------- kernels on meta
def _shapes(ts):
    return [None if t is None else (tuple(t.shape), t.dtype) for t in ts]


def _both(fn, *args, **kw):
    """``fn`` on CPU tensors and on meta copies of them: the outputs."""
    cpu = fn(*args, **kw)
    meta = fn(*[a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args], **kw)
    return cpu, meta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_branch_shapes(dtype):
    """Forward output and lse, the saved (q, k, v, o, lse) and the
    gradients: the plain version's shapes and dtypes."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 6, 16, generator=g).to(dtype)
    k = torch.randn(2, 40, 2, 16, generator=g).to(dtype)
    v = torch.randn(2, 40, 2, 16, generator=g).to(dtype)
    outs = {}
    for dev in ("cpu", "meta"):
        qq, kk, vv = (t.detach().to(dev).requires_grad_(True)
                      for t in (q, k, v))
        o = ops.flash_attention(qq, kk, vv, True, kv_tile=128)
        saved = o.grad_fn.saved_tensors
        o.backward(torch.ones_like(o))
        outs[dev] = _shapes([o] + list(saved) + [qq.grad, kk.grad, vv.grad])
    assert outs["meta"] == outs["cpu"]
    kmeta.reset()
    qm, km, vm = (t.to("meta") for t in (q, k, v))
    o, lse = fa.flash_attention(qm, km, vm, True, kv_tile=128, with_lse=True)
    fa.flash_attention_bwd(qm, km, vm, o, lse, o)
    pairs = 4 * 2 * 6 * 16 * (40 * 41 // 2)
    assert kmeta.COST["flops"] == 3.5 * pairs
    assert kmeta.COST["calls"] == {fa.KERNELS[dtype][0]: 1,
                                   fa.BWD_KERNELS[dtype]: 1}


SCRATCH_PROBE = r"""
#include "flash_bwd_work.cuh"
extern "C" size_t work_bytes(int f32, int b, int t, int s, int h, int hk,
                             int d) {
  return f32 ? 4 * fa_bwd_f32_work_floats(b, t, s, h, hk, d)
             : fa_bwd_bf16_work_bytes(b, t, s, h, hk, d);
}
"""


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_scratch_matches_the_kernels_header(dtype, tmp_path):
    """``flash_attention.bwd_work_bytes`` (the scratch the dry run makes
    on meta) equals what the backward libraries' ``<name>_work_bytes``
    return: ``csrc/flash_bwd_work.cuh``'s functions, compiled here with
    the host's C++ compiler, over ragged T and S, GQA and every head
    dim (112 runs the f32 kernel's 128)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the header's probe")
    src = tmp_path / "probe.cc"
    src.write_text(SCRATCH_PROBE)
    lib = tmp_path / "probe.so"
    subprocess.run([cxx, "-shared", "-fPIC", "-O1", "-I",
                    os.path.join(REPO, "src", "repro_torch", "kernels",
                                 "csrc"), str(src), "-o", str(lib)],
                   check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).work_bytes
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_size_t
    f32 = int(dtype == torch.float32)
    n = 0
    for B, T, S, H, HK in ((1, 1, 1, 6, 2), (2, 127, 129, 24, 2),
                           (3, 128, 1500, 12, 12), (2, 4096, 4096, 24, 8),
                           (1, 8192, 8192, 32, 32)):
        for D in fa.HEAD_DIMS:
            want = fn(f32, B, T, S, H, HK, D)
            assert fa.bwd_work_bytes(dtype, B, T, S, H, HK, D) == want, (
                B, T, S, H, HK, D)
            n += 1
    assert n == 25


def test_wkv6_meta_branch_shapes():
    """y and the final state, the gradients; the forward keeps the chunk
    states the CUDA kernel keeps for its backward ((B, H, chunks, K, K)
    f32; the plain version keeps none), and the step kernel's decode."""
    g = torch.Generator().manual_seed(1)
    B, T, H, K = 2, 70, 2, 16
    r, k, v = (torch.randn(B, T, H, K, generator=g) for _ in range(3))
    w = torch.rand(B, T, H, K, generator=g) * 0.5 + 0.4
    u = torch.randn(H, K, generator=g)
    s0 = torch.randn(B, H, K, K, generator=g)
    outs = {}
    kmeta.reset()
    for dev in ("cpu", "meta"):
        ins = [t.detach().to(dev).requires_grad_(True)
               for t in (r, k, v, w, u, s0)]
        y, s = ops.wkv6(*ins)
        saved = y.grad_fn.saved_tensors
        (y.sum() + s.sum()).backward()
        outs[dev] = (_shapes([y, s] + [t.grad for t in ins]), saved)
    assert outs["meta"][0] == outs["cpu"][0]
    assert outs["meta"][1][-1].shape == (B, H, -(-T // ref.WKV_CHUNK), K, K)
    assert _shapes(outs["meta"][1][:-1]) == _shapes(outs["cpu"][1][:-1])
    assert kmeta.COST["calls"] == {"wkv6_fwd": 1, "wkv6_bwd": 1}
    assert kmeta.COST["flops"] == (5 + 14) * K * K * B * T * H
    with torch.no_grad():
        cpu, meta = _both(ops.wkv6, r[:, :1], k[:, :1], v[:, :1], w[:, :1],
                          u, s0)
    assert _shapes(meta) == _shapes(cpu)


def test_codec_meta_branch_shapes():
    """The six codec kernels' outputs on meta: the plain versions'."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3000, generator=g)
    s = torch.rand(3000, generator=g) - 0.5
    step = torch.rand(3000, generator=g) + 0.5
    cpu, meta = _both(ops.fused_pack_encode, x, s, step, 8, 100)
    assert _shapes([meta]) == _shapes([cpu])
    cpu, meta = _both(ops.fused_unpack_decode, cpu, s, step, None, 8,
                      (3000,))
    assert _shapes([meta]) == _shapes([cpu])
    cpu, meta = _both(ops.dither_pack_encode, x, s, 0.1, 8)
    assert _shapes([meta[0]]) == _shapes([cpu[0]]) and meta[1] == cpu[1]
    cpu, meta = _both(ops.dither_unpack_decode, cpu[0], s, 0.1, 8, (3000,))
    assert _shapes([meta]) == _shapes([cpu])
    layer = torch.rand(3000, generator=g)
    cpu, meta = _both(ops.layered_encode, x, s + 0.5, layer, 0.5)
    assert _shapes([meta]) == _shapes([cpu])
    cpu, meta = _both(ops.layered_decode, cpu, s + 0.5, layer, 0.5)
    assert _shapes([meta]) == _shapes([cpu])


# ------------------------------------------------------------- tracker
def test_tracker_peak_on_a_hand_counted_sequence():
    """a (4 KiB) and b (8 KiB) live: 12 KiB; c = a + a (4 KiB) while a
    lives: 16 KiB; a freed, d = c.view (no new storage), e (2 KiB): 14
    KiB; the peak 16 KiB, the argument (1 KiB) counted from the start."""
    arg = torch.empty(256, device="meta")
    t = dryrun.MemoryTracker("meta")
    t.add(arg)
    with t:
        a = torch.empty(1024, device="meta")
        b = torch.empty(2048, device="meta")
        assert t.cur == 1024 + 12 * 1024
        c = a + a
        assert t.cur == 1024 + 16 * 1024
        del a
        d = c.view(32, 32)
        e = torch.empty(512, device="meta")
        assert t.cur == 1024 + 14 * 1024
        del b, c, d, e
    assert t.peak == 1024 + 16 * 1024
    assert t.cur == 1024
    assert t.io_bytes == 3 * 4096


# ----------------------------------------------------------------- CLI
def test_cli_writes_a_cell_with_the_reference_keys(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one decode cell writes
    its JSON under --out with the reference's keys, device meta."""
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=_env(), check=True, timeout=300, capture_output=True)
    rec = json.loads((tmp_path / "qwen1.5-0.5b_decode_32k.json").read_text())
    assert REF_KEYS <= set(rec)
    assert set(rec["memory"]) == REF_MEMORY
    assert set(rec["collective_bytes"]) == set(coll.COLLECTIVES)
    assert rec["device"] == "meta" and rec["mesh"] == "16x16"
    assert rec["collective_counts"]["all-reduce"] > 0
