"""Compare two versions of the port's MoE routing on phi3.5-moe's serve
path on the card, in one process.

    PYTHONPATH=src python3 tools/torch_moe_route_ab.py OTHER/moe.py

``OTHER/moe.py`` is another tree's ``src/repro_torch/models/moe.py`` (for
example the parent commit unpacked with ``git archive``); its ``route``
is "P", this tree's is "C".  phi3.5-moe is built as ``chip_smoke.py``'s
phase 3g builds it (full width, 24 layers, bf16, seed 0).  With each
route in turns P C C P: ``chip_smoke.profile_serve`` (device ms of a
1024-token prefill and of a decode step under ``torch.profiler``), then
windows of 1024-token prefills in turns P C C P P C C P P C C P, each
prefill timed on the host clock from its call to its return (the host's
dispatch) and to a synchronize after it (the wall).  Prints one JSON
line per route.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

ARCH, LAYERS, PROMPT, REPS = "phi3.5-moe-42b-a6.6b", 24, 1024, 12


def main(other: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import moe
    from repro_torch.serve import ServeEngine

    spec = importlib.util.spec_from_file_location("moe_other", other)
    moe_other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(moe_other)
    routes = {"P": moe_other.route, "C": moe.route}

    build.build_all(("flash_attention_sm90",))
    dev = torch.device("cuda", 0)
    cfg = cs.moe_config(ARCH, LAYERS)
    model = cs.build_checked(cfg, dev)
    out = {t: {"prefill_device_ms": [], "decode_device_ms": [],
               "host_ms": [], "wall_ms": []} for t in routes}
    for tag in "PCCP":
        moe.route = routes[tag]
        p = cs.profile_serve(cfg, model, dev)
        out[tag]["prefill_device_ms"].append(p["prefill_1024"]["device_ms"])
        out[tag]["decode_device_ms"].append(p["decode_step"]["device_ms"])

    eng = ServeEngine(cfg, max_slots=cs.SERVE_SLOTS,
                      max_prefill_len=cs.SERVE_PREFILL,
                      max_gen_len=cs.SERVE_GEN, device=dev)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(REPS, PROMPT), dtype=np.int32)
    for tag in "PCCPPCCPPCCP":
        moe.route = routes[tag]
        for i in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill(model, prompts[i])
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out[tag]["host_ms"].append((t1 - t0) * 1e3)
            out[tag]["wall_ms"].append((t2 - t0) * 1e3)
    moe.route = routes["C"]
    for tag, r in out.items():
        print("ROUTE_AB", json.dumps({
            "route": tag, "prefill_device_ms": r["prefill_device_ms"],
            "decode_device_ms": r["decode_device_ms"], "prefills": REPS * 6,
            "host_median_ms": statistics.median(r["host_ms"]),
            "wall_median_ms": statistics.median(r["wall_ms"]),
            "wall_min_ms": min(r["wall_ms"]),
            "wall_max_ms": max(r["wall_ms"])}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
