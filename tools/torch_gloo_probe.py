"""Which collectives torch.distributed's gloo backend takes for the card's
tensors when ranks share one card (as phases 3b, 3e and 3q of
``chip_smoke.py`` run them), what each costs, and whether ``torch.mm``
takes ``out_dtype`` (the row-parallel product's f32 partial,
``models.nn.row_parallel``).

    python3 tools/torch_gloo_probe.py [--out build/gloo_probe.json]
        [--device cpu --quick]

For 2 and then 4 ranks on card 0 (gloo over localhost), each of f32,
bf16, int32 and uint8 at (8, 1024), (2048, 1024) and (4096, 4096):
``all_gather_into_tensor`` held against the concatenation of the ranks'
blocks, ``all_reduce`` / ``reduce_scatter_tensor`` (floats; integer-valued
inputs, so every order sums exactly) against their sums,
``all_to_all_single`` and ``broadcast`` against their definitions; each
op's ms (the mean of 20 calls, 3 at the largest shape, after one); and,
beside the gather, the gather as ``dist.collectives`` made it before
(one int32 all-reduce of the blocks' bits in a zero buffer of all of
them, 2- and 1-byte dtypes widened to int32).  An op that raises is
recorded with its error.  Prints one JSON line per (ranks, dtype, shape),
the ``mm`` check, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import time
import traceback

SHAPES = ((8, 1024), (2048, 1024), (4096, 4096))
DTYPES = ("float32", "bfloat16", "int32", "uint8")


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(fn, reps):
    import torch.distributed as dist

    fn()
    _sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def _emulated_gather(x, n, r):
    """The gather as one int32 all-reduce of the blocks' bits."""
    import torch
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1)
    w = (flat.view(torch.int32) if x.element_size() == 4 else flat.view(
        torch.int16 if x.element_size() == 2 else torch.uint8).to(
        torch.int32))
    buf = torch.zeros((n, w.numel()), dtype=torch.int32, device=x.device)
    buf[r] = w
    dist.all_reduce(buf)
    return buf


def _case(x, n, r, reps) -> dict:
    import torch
    import torch.distributed as dist

    row = {}

    def attempt(name, run, check):
        try:
            got = run()
            row[name] = bool(check(got))
            row[name + "_ms"] = _timed(run, reps)
        except Exception as e:  # recorded: the probe's finding
            row[name] = f"{type(e).__name__}: {str(e)[:200]}"

    base = torch.arange(x.numel(), device=x.device).reshape(x.shape) % 7
    blocks = [(base + 3 * k).to(x.dtype) for k in range(n)]
    mine = blocks[r]
    whole = torch.cat(blocks)

    def gather():
        out = torch.empty(n * mine.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, mine.reshape(-1))
        return out.reshape(whole.shape)

    attempt("all_gather_into_tensor", gather,
            lambda got: torch.equal(got, whole))
    attempt("emulated_gather", lambda: _emulated_gather(mine, n, r),
            lambda got: True)
    if x.dtype.is_floating_point:
        total = sum(b.to(torch.float32) for b in blocks).to(x.dtype)

        def reduce():
            y = mine.clone()
            dist.all_reduce(y)
            return y

        attempt("all_reduce", reduce, lambda got: torch.equal(got, total))

        def scatter():
            out = torch.empty(mine.numel() // n, dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, mine.reshape(-1))
            return out

        attempt("reduce_scatter_tensor", scatter, lambda got: torch.equal(
            got, total.reshape(-1).chunk(n)[r]))

        def a2a():
            out = torch.empty_like(mine)
            dist.all_to_all_single(out, mine)
            return out

        attempt("all_to_all_single", a2a, lambda got: torch.equal(
            got, torch.cat([b.chunk(n)[r] for b in blocks])))

        def bcast():
            y = mine.clone()
            dist.broadcast(y, 0)
            return y

        attempt("broadcast", bcast, lambda got: torch.equal(got, blocks[0]))
    return row


def _rank(r, n, port, q, device, shapes):
    import torch
    import torch.distributed as dist

    out = {}
    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(device)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=r, world_size=n)
        for dt in DTYPES:
            for shape in shapes:
                x = torch.ones(shape, dtype=getattr(torch, dt), device=device)
                reps = 3 if shape[0] >= 4096 else 20
                out[f"{dt} {shape}"] = _case(x, n, r, reps)
        dist.destroy_process_group()
    except Exception:
        out["error"] = traceback.format_exc()
    q.put((r, out))


def mm_out_dtype() -> dict:
    """``torch.mm(a, b, out_dtype=f32)`` on the card's bf16 operands
    against the f32 product of the widened operands."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(256, 1024, generator=gen, device="cuda").bfloat16()
    b = torch.randn(1024, 512, generator=gen, device="cuda").bfloat16()
    try:
        got = torch.mm(a, b, out_dtype=torch.float32)
        want = torch.mm(a.double(), b.double())
        return {"dtype": str(got.dtype),
                "max_abs_err": float((got.double() - want).abs().max()),
                "max_abs": float(want.abs().max())}
    except Exception as e:  # recorded: the probe's finding
        return {"error": f"{type(e).__name__}: {str(e)[:200]}"}


def main(argv=None) -> int:
    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/gloo_probe.json")
    ap.add_argument("--device", default="cuda:0",
                    help="cpu rehearses the probe without a card")
    ap.add_argument("--quick", action="store_true",
                    help="the two smaller shapes only")
    args = ap.parse_args(argv)
    shapes = SHAPES[:2] if args.quick else SHAPES
    on_card = args.device.startswith("cuda")
    res = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "card": torch.cuda.get_device_name(0) if on_card else "cpu",
           "mm": mm_out_dtype() if on_card else None}
    print(json.dumps({"mm_out_dtype": res["mm"]}), flush=True)
    ctx = mp.get_context("spawn")
    for n in (2, 4):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank, args=(r, n, port, q, args.device,
                                                 shapes)) for r in range(n)]
        for p in procs:
            p.start()
        got = dict(q.get(timeout=900) for _ in range(n))
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
        res[str(n)] = got[0]
        for r in range(n):
            if "error" in got[r]:
                print(f"{n} ranks, rank {r}: {got[r]['error']}")
        for k, v in got[0].items():
            print(json.dumps({"ranks": n, "case": k, **v}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
            .stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
