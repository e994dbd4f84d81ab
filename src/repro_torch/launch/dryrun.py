"""Multi-pod dry run (the port of ``repro.launch.dryrun``): a step of every
(architecture x input shape) cell on the production meshes, (16, 16)
``(data, model)`` and (2, 16, 16) ``(pod, data, model)``, recording each
rank's memory, operations and the bytes each collective kind moves.

No array is allocated: the dry run runs **rank 0's program on meta
tensors**.  Its inputs are rank 0's blocks (``sharding.shard_shape``
under the cell's shardings) on ``device="meta"``, and its mesh is rank 0
of the production mesh on ``collectives.RecordingGroup``s, whose
collectives move nothing, fill their results at the true shape and dtype
and record their kind and result bytes.  Every rank of the production
mesh runs the same shapes (``spec_for_axes`` only picks axes that divide
a dimension, so every rank's block has one shape), so rank 0 stands for
all of them.  The hand-written kernels' wrappers check and allocate as
on the card (outputs, the tensors saved for the backward, scratch) and
charge their operations and bytes (``kernels.meta``) in place of the
launch.

The record keeps the reference's keys, so a reader of its JSON reads this
one unchanged; what each holds here:

  lower_s          building the abstract inputs, their shardings and
                   rank 0's blocks of them
  compile_s        the meta run of the step
  flops            the matrix products' operations by the formulas of
                   ``torch.utils.flop_counter`` (``FlopCounterMode``'s
                   registry, read by ``MemoryTracker`` at each op) plus
                   the kernels' own
  bytes_accessed   the bytes of the inputs and outputs of every aten op
                   that is not a view or an ``empty``, plus each kernel's
                   inputs and outputs (not XLA's measure)
  memory           argument_size_in_bytes (rank 0's inputs),
                   output_size_in_bytes, alias_size_in_bytes (outputs
                   sharing an input's storage), temp_size_in_bytes (the
                   peak of live bytes during the step, less the
                   arguments: ``MemoryTracker`` follows every storage from
                   its making to its freeing, the autograd graph's saved
                   tensors and the microbatch loop's accumulators
                   included), generated_code_size_in_bytes (0)
  collective_bytes / collective_counts
                   by kind (``collectives.COLLECTIVES``): result-shape
                   bytes per device in the dtype moved (a bf16 sum moves
                   f32); collective-permute stays 0, the port issues none
  device           "meta"; with ``--replay`` also "replay": the same
                   program of rank 0 run on the card

``--replay`` runs rank 0's program again on the card: its inputs made on
``cuda`` at their block shapes (random weights and tokens, zero optimizer
moments and caches, so every later op stays finite and every index in
range), the recording groups filling each collective's result as if every
rank held this rank's tensor.  It adds the card's allocated (and
requested) bytes after placing the inputs,
``torch.cuda.max_memory_allocated()`` during the step
beside the meta prediction, the kernels' launches, the step's wall time
(a one-rank replay with no communication: no claim about the mesh's
speed) and the card's ``nvidia-smi`` name and power limit.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.dist import collectives as coll
from repro_torch.dist import meshctx, sharding
from repro_torch.dist.compress import CompressionConfig
from repro_torch.kernels import meta as kmeta
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import nn, registry
from repro_torch.train import steps

_COLLECTIVES = coll.COLLECTIVES
_NO_BYTES = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided")


def collective_bytes(record: dict):
    """The recording groups' sums, bucketed by collective kind: (bytes,
    counts), result-shape bytes per device (the reference reads the same
    from the optimized HLO)."""
    return ({k: int(record["bytes"][k]) for k in _COLLECTIVES},
            {k: int(record["counts"][k]) for k in _COLLECTIVES})


class MemoryTracker(TorchDispatchMode):
    """Follows every storage on ``device`` made by an aten op (or given to
    ``add``) from its making until it is freed: ``cur`` live bytes,
    ``peak`` their maximum; ``io_bytes`` sums the inputs and outputs of
    every op but views and ``empty``s; ``flops`` counts the ops that
    ``torch.utils.flop_counter`` has a formula for (the matrix products),
    by that formula."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.live: dict = {}
        self.cur = self.peak = self.io_bytes = self.flops = 0

    def _free(self, key) -> None:
        self.cur -= self.live.pop(key, 0)

    def add(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self.add(t)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:  # the operands (an out_dtype left out)
            self.flops += formula(*(a for a in args
                                    if isinstance(a, torch.Tensor)),
                                  out_val=out)
        if not (getattr(func, "is_view", False)
                or func.overloadpacket.__name__ in _NO_BYTES):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.io_bytes += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        return out


def build_cell(arch: str, shape_name: str, mesh, compress: str = "none",
               opts: dict | None = None):
    """Returns (fn, args, in_shardings): the step, its global inputs as
    meta tensors (a Python int for the train step's seed) and their
    NamedShardings on ``mesh``.

    ``opts`` (the reference's perf-iteration knobs):
      remat: override remat policy ("full"|"dots"|"none")
      accum: override grad accumulation
      msg_dtype: compression psum payload ("int32"|"int16"|"int8")
      serve_resident: serving weights resident (no ZeRO gather)
      serve_bf16: serving weights stored bf16
      gather_once: gather the compute copy over data once a step
      moe_ep: the moe kind's expert-parallel branch
    """
    opts = opts or {}
    grad_accum = opts.get("accum") or _grad_accum(arch, shape_name)
    return build_step(configs.get_config(arch), configs.SHAPES[shape_name],
                      mesh, compress, dict(opts, accum=grad_accum))


def build_step(cfg, sh: dict, mesh, compress: str = "none",
               opts: dict | None = None):
    """``build_cell`` for a config ``cfg`` and a cell ``sh`` (a
    ``configs.SHAPES`` entry: seq_len, global_batch, step), ``opts``'s
    ``accum`` the microbatches (default 1)."""
    opts = opts or {}
    if opts.get("remat"):
        cfg = cfg.scaled(remat=opts["remat"])
    if opts.get("moe_ep"):
        cfg = cfg.scaled(moe_ep=True)
    meshctx.set_mesh(mesh)
    comp = None
    if compress != "none":
        comp = CompressionConfig(mechanism=compress, sigma=1e-4, clip=1.0,
                                 msg_dtype=opts.get("msg_dtype") or "int32")
    tc = steps.TrainConfig(
        optimizer="adamw", lr=1e-4,
        grad_accum=opts.get("accum") or 1,
        compression=comp, gather_once=bool(opts.get("gather_once")),
    )
    rep = sharding.NamedSharding(mesh, sharding.P())

    if sh["step"] == "train":
        state = steps.make_train_state_specs(cfg, tc)
        state_sh = steps.train_state_shardings(cfg, tc, mesh)
        batch = steps.input_specs(cfg, sh)
        batch_sh = steps.batch_shardings(cfg, sh, mesh)
        step = steps.build_train_step(cfg, tc, mesh=mesh, placed=True)
        return step, (state, batch, 0), (state_sh, batch_sh, rep)

    # inference: params only (no optimizer state)
    pspecs = registry.param_specs(cfg)
    params = nn.abstract_params(pspecs)
    if opts.get("serve_bf16"):
        params = nn.map_specs(
            lambda _, s: torch.empty(s.shape, dtype=torch.bfloat16,
                                     device="meta"), pspecs)
    rules = (sharding.SERVE_RESIDENT_RULES if opts.get("serve_resident")
             else (sharding.EP_PARAM_RULES if opts.get("moe_ep")
                   else sharding.PARAM_RULES))
    params_sh = sharding.param_shardings(pspecs, mesh, rules)
    batch = steps.input_specs(cfg, sh)
    batch_sh = steps.batch_shardings(cfg, sh, mesh)
    if sh["step"] == "prefill":
        fn = steps.build_prefill_step(cfg)
        return fn, (params, batch), (params_sh, batch_sh)

    # decode
    B, S = sh["global_batch"], sh["seq_len"]
    cache = registry.decode_state_specs(cfg, B, S)
    cache_sh = registry.decode_state_shardings(cfg, mesh, B, S)
    fn = steps.build_serve_step(cfg, cache_sh)
    return fn, (params, batch, cache), (params_sh, batch_sh, cache_sh)


def _grad_accum(arch: str, shape_name: str) -> int:
    """Microbatching of the train cell: 8 (batch 256 -> 32 sequences a
    microbatch, divisible by (pod, data) on both meshes)."""
    if shape_name != "train_4k":
        return 1
    return 8


# ------------------------------------------------------------ placement
def _map(fn, tree, shardings, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, shardings[k], path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s, path + (i,))
                          for i, (v, s) in enumerate(zip(tree, shardings)))
    return fn(path, tree, shardings)


def _leaves(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# what each argument of a cell's step is, by step kind
ROLES = {"train": ("state", "batch", "seed"), "prefill": ("params", "batch"),
         "decode": ("params", "batch", "cache")}


def place(args, shardings, device, roles, cfg=None, seed: int = 0):
    """Rank 0's blocks of ``args`` (``roles``: what each argument is) on
    ``device``: empty meta tensors, or on a card values that keep the step
    finite and in range: random weights (0.02 N(0, 1)), frames, patches
    and tokens; zeros for the optimizer state, the step count and the
    caches."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def one(path, x, ns):
        if not isinstance(x, torch.Tensor):
            return x
        shape = sharding.shard_shape(x.shape, ns.spec, ns.mesh)
        if device.type == "meta":
            return torch.empty(shape, dtype=x.dtype, device=device)
        role = roles[path[0]]
        if role == "batch" and path[-1] == "tokens":
            return torch.randint(0, cfg.vocab, shape, generator=gen,
                                 dtype=x.dtype, device=device)
        if (role == "cache" or not x.is_floating_point()
                or (role == "state" and path[1] != "params")):
            return torch.zeros(shape, dtype=x.dtype, device=device)
        return torch.randn(shape, generator=gen, dtype=x.dtype,
                           device=device).mul_(0.02)

    return _map(one, tuple(args), tuple(shardings))


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _storages(ts) -> dict:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in ts}


def _run(fn, args, train: bool):
    if train:
        return fn(*args)
    with torch.no_grad():
        return fn(*args)


def run_meta(fn, args, train: bool) -> dict:
    """``fn(*args)`` on meta tensors under the memory tracker: the
    record's numbers."""
    tracker = MemoryTracker("meta")
    arg_leaves = _leaves(args)
    for t in arg_leaves:
        tracker.add(t)
    arg_bytes = tracker.cur
    kmeta.reset()
    t0 = time.time()
    with tracker:
        out = _run(fn, args, train)
    run_s = time.time() - t0
    out_leaves = _leaves(out)
    outs, ins = _storages(out_leaves), _storages(arg_leaves)
    return {
        "compile_s": run_s,
        "flops": float(tracker.flops) + kmeta.COST["flops"],
        "bytes_accessed": float(tracker.io_bytes) + kmeta.COST["bytes"],
        "memory": {
            "temp_size_in_bytes": int(tracker.peak - arg_bytes),
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(sum(outs.values())),
            "alias_size_in_bytes": int(sum(n for k, n in outs.items()
                                           if k in ins)),
            "generated_code_size_in_bytes": 0,
        },
        "kernel_calls": dict(sorted(kmeta.COST["calls"].items())),
    }


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card, or what
    went wrong."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def _launches() -> dict:
    from repro_torch.kernels import dither_pack, fused_agg, layered_encode
    from repro_torch.kernels import flash_attention, wkv6

    out = {}
    for mod in (flash_attention, wkv6, fused_agg, dither_pack,
                layered_encode):
        out.update(mod.LAUNCHES)
    return dict(out)


def _requested(device) -> int:
    """The caching allocator's requested bytes now (the sizes asked for,
    before its rounding to 512 bytes and a large block's unsplit rest)."""
    return int(torch.cuda.memory_stats(device).get(
        "requested_bytes.all.current", 0))


def run_replay(fn, args, shardings, step_kind: str, cfg, device="cuda",
               seed: int = 0) -> dict:
    """Rank 0's program on the card (see the module's docstring):
    allocated bytes after placing the inputs, the step's peak, launches,
    wall time, and the mesh's collectives as recorded in this run."""
    device = torch.device(device)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    base_req = _requested(device)
    real = place(args, shardings, device, ROLES[step_kind], cfg, seed)
    torch.cuda.synchronize(device)
    placed = torch.cuda.memory_allocated(device) - base
    requested = _requested(device) - base_req
    arg_leaves = _leaves(real)
    torch.cuda.reset_peak_memory_stats(device)
    before = _launches()
    t0 = time.time()
    out = _run(fn, real, step_kind == "train")
    torch.cuda.synchronize(device)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) - base
    after = _launches()
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(out)
                 if t.is_floating_point())
    del out, real
    return {"argument_bytes": _nbytes(arg_leaves),
            "argument_tensors": len(arg_leaves),
            "allocated_after_placing": int(placed),
            "requested_after_placing": int(requested),
            "peak_bytes": int(peak),
            "wall_s": wall,
            "finite": finite,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "card": card_name(),
            "note": "one-rank replay of rank 0, no communication: no claim "
                    "about the mesh's speed"}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             compress: str = "none", tag: str = "", opts: dict | None = None,
             replay: bool = False):
    record = coll.new_record()
    mesh = make_production_mesh(multi_pod=multi_pod, record=record)
    t0 = time.time()
    fn, args, shardings = build_cell(arch, shape_name, mesh, compress, opts)
    kind = configs.SHAPES[shape_name]["step"]
    local = place(args, shardings, "meta", ROLES[kind])
    t_lower = time.time() - t0
    got = run_meta(fn, local, kind == "train")
    del local
    coll_b, counts = collective_bytes(record)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "compress": compress,
        "lower_s": round(t_lower, 1),
        "compile_s": round(got["compile_s"], 1),
        "flops": got["flops"],
        "bytes_accessed": got["bytes_accessed"],
        "memory": got["memory"],
        "collective_bytes": coll_b,
        "collective_counts": counts,
        "device": "meta",
        "rank": 0,
        "kernel_calls": got["kernel_calls"],
    }
    if replay:
        cfg = configs.get_config(arch)
        for k in record:
            record[k] = dict.fromkeys(_COLLECTIVES, 0)
        r = run_replay(fn, args, shardings, kind, cfg)
        r["collective_bytes"], r["collective_counts"] = collective_bytes(
            record)
        rec["replay"] = r
    meshctx.set_mesh(None)
    os.makedirs(out_dir, exist_ok=True)
    suffix = ("_mp" if multi_pod else "") + (f"_{tag}" if tag else "")
    path = os.path.join(out_dir, f"{arch}_{shape_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {arch} x {shape_name} ({rec['mesh']}, "
          f"compress={compress}): meta run {got['compile_s']:.1f}s "
          f"flops={rec['flops']:.3e} "
          f"coll={sum(coll_b.values()) / 1e9:.2f}GB -> {path}")
    print(f"  memory: {rec['memory']}")
    if replay:
        print(f"  replay: {rec['replay']}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--compress", default="none")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--msg-dtype", default="int32")
    ap.add_argument("--serve-resident", action="store_true")
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--gather-once", action="store_true")
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--replay", action="store_true",
                    help="also run rank 0's program on the card")
    args = ap.parse_args()
    opts = {"remat": args.remat, "accum": args.accum,
            "msg_dtype": args.msg_dtype,
            "serve_resident": args.serve_resident,
            "serve_bf16": args.serve_bf16,
            "gather_once": args.gather_once,
            "moe_ep": args.moe_ep}

    if args.all:
        ok, fail = 0, []
        for arch, shape_name in configs.cells():
            try:
                run_cell(arch, shape_name, args.multi_pod, args.out,
                         args.compress)
                ok += 1
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                fail.append((arch, shape_name, str(e)[:200]))
        print(f"[dryrun] {ok} cells OK, {len(fail)} failed")
        for f in fail:
            print("  FAIL:", f)
        raise SystemExit(1 if fail else 0)

    run_cell(args.arch, args.shape, args.multi_pod, args.out,
             args.compress, args.tag, opts, replay=args.replay)


if __name__ == "__main__":
    main()
