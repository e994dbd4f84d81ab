"""Training launcher (the port of ``repro.launch.train``).

Selects an architecture (--arch), an AINQ compression mechanism for the
gradients, and runs the training loop: deterministic restartable data
stream, periodic asynchronous checkpoints, resume from the latest
committed checkpoint.  Runs on the CUDA card unless ``--device cpu``
(the kernels' plain versions).

CPU usage (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --device cpu --steps 3 --mechanism aggregate_gaussian \\
      --no-per-coord --fused
  (--arch zamba2-7b --smoke as well: its sequence a multiple of the SSD
  chunk, 8 in the smoke config, 128 in the full one; --arch whisper-small
  --smoke trains on the frames stub, ``encoder_len`` frames a row)

Async actor/learner mode (repro_torch.runtime): N client threads or
processes exchange integer messages with a staleness-aware learner —
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --device cpu --runtime async --transport thread \\
      --clients 3 --rounds 2 --mechanism aggregate_gaussian --sigma 1e-3 \\
      --no-per-coord

As in the JAX launcher, whose host mesh has no ``pod`` axis, the sync
loop runs the n = 1 step; the step across client ranks is
``train.steps.build_train_step(..., group=)``.  Under a launcher that
sets ``RANK`` / ``WORLD_SIZE`` the loop runs on a ``make_host_mesh(data=
world, model=1)`` mesh (``launch.mesh.launcher_mesh``): FSDP over the
ranks, each with its rows of every batch, checkpoints of whole leaves,
and resume re-placing them on this mesh.  The JAX launcher's
``--compilation-cache`` has no counterpart: nothing is compiled at run
time but the CUDA kernels, which ``kernels/build.py`` caches by source.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import checkpoint
from repro_torch.data import synthetic
from repro_torch.dist.compress import CompressionConfig
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.train import steps


def run_async(args) -> None:
    """Async actor/learner FL: integer-message rounds over a transport,
    staleness-aware aggregation."""
    from repro_torch.fl.federated import FLConfig
    from repro_torch.runtime import (
        AsyncFederatedRuntime,
        ModelGradWorkload,
        RuntimeConfig,
    )
    from repro_torch.runtime import chaos as chaos_mod

    if args.mechanism == "none":
        raise SystemExit(
            "--runtime async needs a mechanism with an integer wire "
            "format (e.g. aggregate_gaussian); 'none' has none")
    device = resolve_device(args.device)
    seq = args.seq or (32 if args.smoke else 4096)
    batch = args.batch or (2 if args.smoke else 256)
    plan = None
    if args.chaos:
        plan = chaos_mod.parse_plan(args.chaos, seed=0,
                                    delay_s=args.chaos_delay,
                                    rejoin_after_s=args.chaos_rejoin)
        print(f"[train] chaos plan: {plan}")
    fl = FLConfig(
        n_clients=args.clients, mechanism=args.mechanism, sigma=args.sigma,
        clip=args.clip, cohort_fraction=args.cohort_fraction, lr=args.lr,
        mech_kwargs=(("per_coord", args.per_coord),
                     ("packed", args.fused),
                     ("msg_bits", args.msg_bits)),
    )
    rc = RuntimeConfig(
        fl=fl, staleness_bound=args.staleness_bound,
        staleness_weighting=args.staleness_weighting, quorum=args.quorum,
        round_timeout_s=args.round_timeout, transport=args.transport,
        straggler_fraction=args.straggler_fraction,
        straggler_delay_s=args.straggler_delay,
        heartbeat_timeout_s=args.heartbeat_timeout,
        chaos=plan,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )
    wl = ModelGradWorkload(arch=args.arch, smoke=args.smoke, seq=seq,
                           batch=batch, data=args.data, device=str(device))
    print(f"[train] async runtime: {args.clients} clients over "
          f"{args.transport} transport, staleness bound "
          f"{args.staleness_bound}, mechanism {args.mechanism}")
    t0 = time.time()
    params0 = wl.init_params()
    rt = AsyncFederatedRuntime(rc, wl, device=device)
    params, summary, _ = rt.run(params0, args.rounds)
    drift = float(np.linalg.norm(np.asarray(params) - params0))
    print(f"[train] {summary['rounds']} rounds in {time.time() - t0:.1f}s "
          f"({summary['rounds_per_sec']:.2f} rounds/s), occupancy "
          f"{summary['mean_cohort_occupancy']:.2f}, "
          f"{summary['bits_per_round']:.0f} bits/round, |dparams| {drift:.3g}")
    print(f"[train] membership: {summary.get('active_members_final')} final "
          f"members, {summary.get('evictions', 0)} evictions, "
          f"{summary.get('joins', 0)} joins, "
          f"{summary.get('degraded_rounds', 0)} degraded rounds, "
          f"{summary.get('learner_restarts', 0)} learner restarts")
    if summary.get("empty_rounds"):
        raise SystemExit(f"{summary['empty_rounds']} empty rounds — no "
                         f"client updates landed; transport broken?")
    if plan is not None and plan.any_faults:
        if not (summary.get("degraded_rounds", 0)
                or summary.get("evictions", 0)
                or summary.get("learner_restarts", 0)):
            raise SystemExit("chaos plan injected faults but the realized-"
                             "cohort metrics show no degradation — fault "
                             "injection broken?")
    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
        print(f"[train] wrote {args.bench_out}")
    print("[train] done")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mechanism", default="none")
    ap.add_argument("--sigma", type=float, default=1e-4)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--per-coord", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="per-coordinate shared randomness (paper-faithful "
                         "i.i.d. noise); --no-per-coord draws per tensor")
    ap.add_argument("--fused", action="store_true",
                    help="fused encode/decode kernels with packed b-bit "
                         "fields (homomorphic mechanisms only); async "
                         "runtime: packed client uplink")
    ap.add_argument("--msg-bits", type=int, default=None,
                    help="packed field width (2..24); default: widest for "
                         "the msg dtype")
    ap.add_argument("--checkpoint-dir", "--ckpt", dest="checkpoint_dir",
                    default=None,
                    help="async checkpoint directory (commit barrier + "
                         "keep-last-k retention)")
    ap.add_argument("--checkpoint-every", "--ckpt-every",
                    dest="checkpoint_every", type=int, default=50,
                    help="steps (sync) / rounds (async) between checkpoints")
    ap.add_argument("--keep-last-k", type=int, default=3,
                    help="checkpoints retained by GC (newest never deleted)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest committed checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--data", default="lm", choices=["lm", "uniform"])
    # --- async actor/learner runtime (repro_torch.runtime) ---
    ap.add_argument("--runtime", default="sync", choices=["sync", "async"])
    ap.add_argument("--transport", default="process",
                    choices=["thread", "process"])
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--staleness-bound", type=int, default=0)
    ap.add_argument("--staleness-weighting", default="uniform",
                    choices=["uniform", "inverse"])
    ap.add_argument("--quorum", type=float, default=1.0)
    ap.add_argument("--round-timeout", type=float, default=120.0)
    ap.add_argument("--cohort-fraction", type=float, default=1.0)
    ap.add_argument("--straggler-fraction", type=float, default=0.0,
                    help="wall-clock straggler probability per (client, "
                         "round) in async mode")
    ap.add_argument("--straggler-delay", type=float, default=0.5)
    ap.add_argument("--heartbeat-timeout", type=float, default=10.0,
                    help="async: members silent this long are evicted "
                         "from future cohorts (clients beacon at 1/4)")
    ap.add_argument("--chaos", default=None,
                    help="async fault plan, e.g. 'client_crash@1:2,"
                         "learner_crash@3' or 'crash_rate=0.2' "
                         "(see repro_torch.runtime.chaos.parse_plan)")
    ap.add_argument("--chaos-delay", type=float, default=0.25,
                    help="hold time for delay/slow_uplink faults")
    ap.add_argument("--chaos-rejoin", type=float, default=None,
                    help="crashed clients rejoin after this many seconds "
                         "(default: crashes are permanent)")
    ap.add_argument("--bench-out", default=None,
                    help="write the async run summary as JSON here")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.runtime == "async":
        return run_async(args)

    device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.smoke:
        cfg = cfg.scaled(compute_dtype="float32")
    seq = args.seq or (32 if args.smoke else 4096)
    batch = args.batch or (4 if args.smoke else 256)

    comp = None
    if args.mechanism != "none":
        comp = CompressionConfig(mechanism=args.mechanism, sigma=args.sigma,
                                 clip=args.clip, per_coord=args.per_coord,
                                 fused=args.fused, msg_bits=args.msg_bits)
    tc = steps.TrainConfig(optimizer="adamw", lr=args.lr,
                           grad_accum=args.grad_accum, compression=comp)
    mesh, device = launcher_mesh(device)
    log = print if mesh is None or mesh.rank == 0 else (lambda *_: None)
    if mesh is not None:
        log(f"[train] mesh {mesh.shape} over {dist.get_backend()} on "
            f"{device}")
    state = steps.init_train_state(cfg, tc, 0, device, mesh=mesh)
    if args.checkpoint_dir and (args.resume
                                or checkpoint.latest_step(args.checkpoint_dir)
                                is not None):
        if checkpoint.latest_step(args.checkpoint_dir) is not None:
            # elastic: placement re-resolved for THIS mesh
            state, last = steps.restore_train_state(
                args.checkpoint_dir, cfg, tc, device=device, mesh=mesh)
            log(f"[train] resumed step {last}"
                + (f" onto mesh {mesh.shape}" if mesh is not None else ""))

    ckpt = None
    if args.checkpoint_dir:
        ckpt = checkpoint.AsyncCheckpointer(
            args.checkpoint_dir, keep_last_k=args.keep_last_k,
            shardings=(steps.train_state_shardings(cfg, tc, mesh)
                       if mesh is not None else None))

    step_fn = steps.build_train_step(cfg, tc, mesh=mesh)
    dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                              kind=args.data)
    batch_fn = synthetic.batch_fn(dc)

    first = int(state["step"])
    t0 = time.time()
    for i in range(first, first + args.steps):
        data = synthetic.with_frontend_stubs(
            batch_fn(dc, i, device=device), cfg)
        state, m = step_fn(state, data, i)
        if i % 10 == 0 or i == first + args.steps - 1:
            dt = time.time() - t0
            log(f"[train] step {i:6d} loss {float(m['loss']):.4f} "
                f"({(i - first + 1) * batch * seq / max(dt, 1e-9):,.0f} "
                f"tok/s)")
        if ckpt is not None and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(i + 1, state)
            log(f"[train] checkpoint {i + 1} queued (async)")
    if ckpt is not None:
        ckpt.close()
    if mesh is not None:  # every rank is past its last collective
        dist.destroy_process_group()
    log("[train] done")


if __name__ == "__main__":
    main()
