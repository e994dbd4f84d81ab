"""The train and serve launchers on a (data = N) mesh of N processes, one
card each (NCCL, as ``launch.mesh.launcher_backend`` picks it), against one
process: the launcher's own path across cards.

    python3 tools/torch_mesh_nccl_check.py [--ranks 4] [--device cuda]

Sets each process's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` as torchrun does,
after building the kernels once.  Checks, as
``tests/test_torch_mesh_launch.py`` does on two CPU processes: the smoke
train loop (f32, 2 steps of 4 x 16 with a checkpoint) reports the single
process's step-0 loss to 4 decimals, and one process resumes its
checkpoint; the smoke engine emits the single process's tokens.  Then
qwen1.5-0.5b at full width in bf16, 3 steps of 8 x 2048 in 2
microbatches (as phase 3d), on the N cards
(FSDP over ``data``) and on one, each launcher's tokens/s line (the mean
over all steps, the first included).  Prints each run's wall, its
``[train]`` / ``[serve]`` lines, the backend, and the card's name and power
limit; exits 1 if a check fails.  ``--device cpu`` rehearses it with gloo
on CPU processes (the full-width runs skipped).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SMOKE_TRAIN = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "2",
               "--batch", "4", "--seq", "16"]
SMOKE_SERVE = ["--arch", "qwen1.5-0.5b", "--smoke", "--requests", "4",
               "--slots", "4", "--prompt-len", "8", "--gen", "4"]
FULL_TRAIN = ["--arch", "qwen1.5-0.5b", "--steps", "3", "--batch", "8",
              "--seq", "2048", "--grad-accum", "2"]


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(module: str, args, world: int, device: str, timeout: float):
    """``python -m module args --device device`` as ``world`` ranks (0: one
    plain process): each process's (returncode, stdout, stderr), and the
    wall from start to the last exit."""
    port = _port()
    procs = []
    t0 = time.perf_counter()
    for r in range(max(world, 1)):
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        if world:
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *args, "--device", device],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            o, e = p.communicate()
        out.append((p.returncode, o, e))
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    on_card = args.device.startswith("cuda")
    failed = []

    def check(ok, what):
        print(("ok: " if ok else "FAILED: ") + what, flush=True)
        if not ok:
            failed.append(what)

    def ran(name, runs, wall):
        for r, (rc, o, e) in enumerate(runs):
            if rc != 0:
                print(f"{name} rank {r} stderr:\n{e[-3000:]}")
        check(all(rc == 0 for rc, _, _ in runs), f"{name} exit codes")
        lines = [ln for ln in runs[0][1].splitlines() if ln.startswith("[")]
        print(json.dumps({"run": name, "wall_s": wall, "lines": lines}),
              flush=True)

    if on_card:
        sys.path.insert(0, SRC)
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        build.build_all()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    n = args.ranks
    train = "repro_torch.launch.train"
    serve = "repro_torch.launch.serve"
    backend = "nccl" if on_card else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        many, wall = launch(train, SMOKE_TRAIN + ["--ckpt", ckpt,
                                                  "--ckpt-every", "2"],
                            n, args.device, 600)
        ran(f"smoke train, {n} ranks", many, wall)
        check(f"over {backend}" in many[0][1], f"the ranks joined {backend}")
        one, wall = launch(train, SMOKE_TRAIN, 0, args.device, 600)
        ran("smoke train, one process", one, wall)
        loss = re.compile(r"step +0 loss ([0-9.]+)")
        got = [loss.search(o) for _, o, _ in (many[0], one[0])]
        check(all(got) and got[0].group(1) == got[1].group(1),
              f"step-0 loss on {n} ranks equals one process's: "
              f"{[g.group(1) if g else None for g in got]}")
        check(all(o == "" for _, o, _ in many[1:]),
              "only rank 0 prints")
        resumed, wall = launch(train, SMOKE_TRAIN[:-4] + [
            "--steps", "1", "--ckpt", ckpt, "--resume"], 0, args.device, 600)
        ran("resume on one process", resumed, wall)
        check("resumed step 2" in resumed[0][1],
              "one process resumes the ranks' checkpoint")
    many, wall = launch(serve, SMOKE_SERVE, n, args.device, 600)
    ran(f"smoke serve, {n} ranks", many, wall)
    one, wall = launch(serve, SMOKE_SERVE, 0, args.device, 600)
    ran("smoke serve, one process", one, wall)
    sample = re.compile(r"sample token ids: (.*)")
    got = [sample.search(o) for _, o, _ in (many[0], one[0])]
    check(all(got) and got[0].group(1) == got[1].group(1),
          f"{n} ranks' tokens equal one process's")
    if on_card:
        for world in (n, 0):
            runs, wall = launch(train, FULL_TRAIN, world, args.device, 900)
            ran(f"qwen1.5-0.5b bf16 8 x 2048, "
                f"{world or 1} card(s)", runs, wall)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
            .stdout.strip())
    print(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
