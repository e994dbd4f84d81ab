"""phi3.5-moe on the (pod, data, model) mesh across cards, one card a rank
over NCCL (``--device cpu``: gloo CPU ranks at the smoke config, a
rehearsal):

    python3 tools/torch_moe_mesh_check.py [--ranks 4] [--device cuda]
        [--serve-layers 32] [--train-layers 4] [--pod-layers 1]

Spawns the ranks (``RANK`` given by position, ``tcp://localhost``), each
on card ``rank``, after building the kernels once, and runs in order:

  * serve on (1, 1, 4), bf16, ``--serve-layers`` of phi3.5-moe's 32 (all
    of them by default: 78 GiB of weights, a quarter a card), under the
    tensor-parallel branch (weights by SERVE_RESIDENT_RULES, each expert's
    d_ff split) and the expert-parallel one (``moe_ep``, weights by
    EP_PARAM_RULES: 4 experts a card at full d_ff, as the reference's dry
    run places them for serving): 8 requests of 256-2048 prompt tokens
    and 8-64 out on 8 slots, one request a prefill call, after a warm-up
    of 2; tokens/s, the median decode step, prefill s, peak GiB a card,
    the same tokens on every rank;
  * train on (1, 2, 2), FSDP + EP (EP_PARAM_RULES, ``moe_ep``), bf16,
    remat full, AdamW lr 3e-4, uncompressed, ``--train-layers`` layers,
    3 steps of 4 x 2048 (2 rows a data rank): step walls, losses, peak
    GiB a card, launches;
  * the compressed step on (2, 1, 2) under NO_FSDP_RULES, without and
    with ``moe_ep`` (the experts resharded from their d_ff blocks at
    use), ``--pod-layers`` layers, aggregate_gaussian fused b = 8
    per-tensor, 2 steps of 4 x 2048: params bitwise equal across the pods
    for each model rank, losses, step walls, peak GiB a card.

Prints one JSON line a job and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them; exits 1 if a check fails.  The times are one card a rank over
NCCL; phase 3r of ``chip_smoke.py`` runs the same paths on gloo ranks
sharing one card, for correctness and launches only.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
SERVE_MESH, TRAIN_MESH, POD_MESH = (1, 1, 4), (1, 2, 2), (2, 1, 2)
SERVE_REQUESTS, SERVE_GEN, SERVE_SLOTS, SERVE_PREFILL = 8, 64, 8, 2048
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, POD_STEPS = 2048, 4, 3, 2
TIMEOUT = 1500.0


def _config(args, layers: int, ep: bool, dtype=None):
    from repro_torch import configs

    if args["device"] == "cpu":
        cfg = configs.get_smoke_config(ARCH).scaled(remat="full")
    else:
        cfg = configs.get_config(ARCH)
    cfg = cfg.scaled(n_layers=min(layers, cfg.n_layers), moe_ep=ep)
    return cfg if dtype is None else cfg.scaled(compute_dtype=dtype)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> float:
    import torch

    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2**30


def _reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def serve_job(mesh, device, args, ep: bool) -> dict:
    import statistics

    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.launch import serve as launch
    from repro_torch.serve import ServeEngine

    cfg = _config(args, args["serve_layers"], ep)
    rules = sharding.EP_PARAM_RULES if ep else None
    _reset_peak(device)
    t0 = time.perf_counter()
    model = launch.build_model(cfg, 0, device, mesh, rules)
    _sync(device)
    build_s = time.perf_counter() - t0
    # the CPU rehearsal's prompts: 256-300 tokens
    prefill = 300 if args["device"] == "cpu" else SERVE_PREFILL
    engine = ServeEngine(cfg, max_slots=SERVE_SLOTS, max_prefill_len=prefill,
                         max_gen_len=SERVE_GEN, device=device)
    cs.SERVE_PREFILL = prefill
    launch.drive(engine, model, [(r, t[:256], 4) for r, t, _
                                 in cs.serve_requests(cfg, 2, seed=9)])
    requests = cs.serve_requests(cfg, SERVE_REQUESTS)
    dist.barrier()
    cs.reset_launches()
    outputs, stats = launch.drive(engine, model, requests)
    _sync(device)
    out = {"layers": cfg.n_layers, "build_s": build_s,
           "tokens_per_s": stats["tokens_per_s"],
           "step_ms_median": statistics.median(stats["step_ms"]),
           "prefill_s": stats["prefill_s"],
           "prompt_tokens": stats["prompt_tokens"],
           "tokens_out": stats["tokens_out"], "wall_s": stats["wall_s"],
           "peak_gib": _peak(device), "launches": cs.read_launches(),
           "w_gate": list(model.layers[0].moe["w_gate"].shape),
           "digest": cs._json_digest(outputs),
           "ok_tokens": all(len(outputs[r]) == g for r, _, g in requests)}
    del engine, model
    return out


def _batch(cfg, i: int, device, rows: int, seq: int):
    from repro_torch.data import synthetic

    dc = synthetic.DataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=rows, kind="lm")
    return synthetic.lm_batch(dc, i, device=device)


def train_job(mesh, device, args, layers: int, ep: bool, comp: bool,
              n_steps: int) -> dict:
    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.train import steps

    cfg = _config(args, layers, ep)
    seq = 16 if args["device"] == "cpu" else TRAIN_SEQ
    tc = steps.TrainConfig(
        optimizer="adamw", lr=3e-4,
        compression=(cs._train_comp("aggregate_gaussian", cs.TRAIN_SIGMA)
                     if comp else None))
    _reset_peak(device)
    state = steps.init_train_state(cfg, tc, 0, device, mesh=mesh)
    step_fn = steps.build_train_step(cfg, tc, mesh=mesh)
    rules = steps.state_rules(cfg, tc, mesh)
    out = {"layers": cfg.n_layers,
           "rules": next(n for n in ("NO_FSDP_RULES", "EP_PARAM_RULES",
                                     "PARAM_RULES")
                         if getattr(sharding, n) is rules),
           "walls": [], "losses": [], "digests": [],
           "local_params": sum(t.numel()
                               for t in cs._leaves(state["params"]))}
    dist.barrier()
    cs.reset_launches()
    for i in range(n_steps):
        batch = _batch(cfg, i, device, TRAIN_BATCH, seq)
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, cs.TRAIN_SEED)
        _sync(device)
        out["walls"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["digests"].append(cs._digest(cs._leaves(state["params"])))
        out["cohort"] = int(m["cohort"])
    out["launches"] = cs.read_launches()
    out["peak_gib"] = _peak(device)
    out["tokens_per_s"] = [TRAIN_BATCH * seq / w for w in out["walls"]]
    del state
    return out


def rank_main(rank: int, n: int, port: int, args, results) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.dist import meshctx

    try:
        torch.set_num_threads(1 if args["device"] == "cpu" else 4)
        if args["device"] == "cpu":
            device, backend = torch.device("cpu"), "gloo"
        else:
            device, backend = torch.device("cuda", rank), "nccl"
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=n)
        jobs = (("serve_tp", SERVE_MESH, serve_job, (False,)),
                ("serve_ep", SERVE_MESH, serve_job, (True,)),
                ("train_fsdp_ep", TRAIN_MESH, train_job,
                 (args["train_layers"], True, False, TRAIN_STEPS)),
                ("pods_tp", POD_MESH, train_job,
                 (args["pod_layers"], False, True, POD_STEPS)),
                ("pods_ep", POD_MESH, train_job,
                 (args["pod_layers"], True, True, POD_STEPS)))
        out = {"rank": rank, "backend": dist.get_backend(), "jobs": {}}
        for name, shape, fn, extra in jobs:
            mesh = meshctx.make_mesh(shape)
            meshctx.set_mesh(mesh)
            t0 = time.perf_counter()
            res = fn(mesh, device, args, *extra)
            res.update(coords=mesh.coords(), job_s=time.perf_counter() - t0)
            out["jobs"][name] = res
            if device.type == "cuda":
                torch.cuda.empty_cache()
        results.put(out)
    except BaseException:  # reported to the parent, then re-raised
        import traceback

        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--serve-layers", type=int, default=32)
    ap.add_argument("--train-layers", type=int, default=4)
    ap.add_argument("--pod-layers", type=int, default=1)
    a = ap.parse_args(argv)
    if a.ranks != 4:
        raise SystemExit("the meshes here are of 4 ranks")
    args = {"device": a.device, "serve_layers": a.serve_layers,
            "train_layers": a.train_layers, "pod_layers": a.pod_layers}
    failed = []

    def check(ok, what):
        print(("ok: " if ok else "FAILED: ") + what, flush=True)
        if not ok:
            failed.append(what)

    if a.device == "cuda":
        import torch

        from repro_torch.kernels import build

        check(torch.cuda.device_count() >= a.ranks,
              f"{torch.cuda.device_count()} cards for {a.ranks} ranks")
        t0 = time.perf_counter()
        build.build_all()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    port = cs.free_port()
    t0 = time.perf_counter()
    got = cs._spawn(rank_main, lambda r: (r, a.ranks, port, args), a.ranks,
                    TIMEOUT)
    print(f"ranks ran {time.perf_counter() - t0:.1f} s", flush=True)
    errors = [g["error"] for g in got if "error" in g]
    for e in errors:
        print(e)
    check(not errors and len(got) == a.ranks, "every rank ran every job")
    if errors or len(got) != a.ranks:
        print(json.dumps({"failed": failed}))
        return 1
    by = {g["rank"]: g for g in got}
    check(all(g["backend"] == ("nccl" if a.device == "cuda" else "gloo")
              for g in got), f"backend {got[0]['backend']}")
    for name in by[0]["jobs"]:
        rows = {r: by[r]["jobs"][name] for r in sorted(by)}
        r0 = rows[0]
        if name.startswith("serve"):
            check(all(g["ok_tokens"] and g["digest"] == r0["digest"]
                      for g in rows.values()),
                  f"{name}: every rank emits the same tokens")
        else:
            check(all(math.isfinite(x) for g in rows.values()
                      for x in g["losses"]), f"{name}: finite losses")
            check(all(g["losses"] == r0["losses"] for g in rows.values()),
                  f"{name}: the same losses on every rank")
        if name.startswith("pods"):
            for r, g in rows.items():
                twin = next(o for o, h in rows.items() if o != r and
                            h["coords"]["model"] == g["coords"]["model"])
                check(g["digests"] == rows[twin]["digests"],
                      f"{name}: rank {r}'s params equal rank {twin}'s "
                      f"(other pod, same model rank)")
            check(all(g["cohort"] == 2 for g in rows.values()),
                  f"{name}: cohort 2")
        print(json.dumps({"job": name, "rank0": {
            k: v for k, v in r0.items() if k not in ("digests", "digest")},
            "peak_gib": {r: g["peak_gib"] for r, g in rows.items()},
            "job_s": {r: g["job_s"] for r, g in rows.items()}}), flush=True)
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
            .stdout.strip(), flush=True)
    print(json.dumps({"failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
