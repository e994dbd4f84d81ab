#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

The main path is one compressed FL round (``repro_torch.fl.federated``
over a packed ``RoundProtocol``) at the full width of the smallest model
in the registry, qwen1.5-0.5b: d = 463,987,712 coordinates, n = 4
clients, b = 8-bit fields, clip 1.0.  Phases, each fatal on failure:

  1. build every CUDA source of the port with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card:
     packed words bitwise, decoded values within 1e-6, at the full-width
     shapes for b in {8, 4, 16, 24}, scalar and array step, with and
     without offset, and on one ragged size;
  3. run FederatedAveraging for aggregate_gaussian (per-coordinate,
     sigma 0.25) and irwin_hall (sigma 5e-3), 2 rounds each, with the
     kernels' launch counts set to 0 just before and read just after;
     check the counts, the wire width and the error law (KS against
     N(0, sigma^2) on a 2^20-coordinate subsample; IH support and std);
  4. time each kernel (CUDA events, median) beside its bound and its
     plain version, and split the round's wall time by phase.

Prints the card's name and power limit, a ``kernels`` JSON line, and as
its last line ``{"ok": true, "device": {...}}``; the full report goes to
``build/chip_smoke.json``.  Needs one CUDA card; exits non-zero with no
result line otherwise.  Run from the repository root:
``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

D_FULL = 463_987_712  # sum of qwen1.5-0.5b's parameter sizes
N_CLIENTS = 4
BITS = 8
CLIP = 1.0
ROUNDS = 2
KS_SAMPLE = 1 << 20
DECODE_ATOL = 1e-6
SOURCE = "src/repro_torch/kernels/csrc/fused_agg.cu"
REPLACES = {"fused_encode": "src/repro/kernels/fused_agg.py:89",
            "fused_decode": "src/repro/kernels/fused_agg.py:115"}
# device-memory rate by card name (NVIDIA data sheets), bytes/s
_MEM_RATES = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
              ("H200", 4.8e12), ("H100", 3.35e12))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


def mem_rate(name: str) -> float:
    for tag, rate in _MEM_RATES:
        if tag in name:
            return rate
    raise RuntimeError(f"no memory rate known for card {name!r}: add it "
                       f"to _MEM_RATES")


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    fn()  # warm up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def ks_stat(samples, sigma: float) -> float:
    import numpy as np

    s = np.sort(np.asarray(samples, np.float64))
    n = len(s)
    erf = np.frompyfunc(math.erf, 1, 1)
    c = 0.5 * (1.0 + erf(s / (sigma * math.sqrt(2.0))).astype(np.float64))
    return max(float(np.max(np.abs(c - np.arange(1, n + 1) / n))),
               float(np.max(np.abs(c - np.arange(n) / n))))


# ------------------------------------------------------------- phase 2
# field clamp per width: the main path's (b = 8, n = 4), and the JAX
# package's kernel sweep for the others (tests/test_kernels.py)
M_MAX = {8: 31, 4: 3, 16: 4000, 24: 80000}


def kernel_inputs(d, bits, gen, device):
    """x ~ U(-1, 1), s ~ U(-1/2, 1/2), a scalar step and a per-coordinate
    one around 1/(m_max - 1), and an offset, all of ``d`` coordinates."""
    import torch

    m_max = M_MAX[bits]
    x = torch.rand(d, generator=gen, device=device) * 2.0 - 1.0
    s = torch.rand(d, generator=gen, device=device) - 0.5
    base = 1.0 / (m_max - 1)
    step = base * (torch.rand(d, generator=gen, device=device) + 0.5)
    offset = torch.rand(d, generator=gen, device=device) * 0.25
    return m_max, x, s, base, step, offset


def compare_kernels(device, gen) -> dict:
    """Each kernel's wrapper against its plain version, same inputs."""
    import torch

    from repro_torch.kernels import fused_agg as fg
    from repro_torch.kernels import ops, ref

    worst = {"fused_encode": 0.0, "fused_decode": 0.0}
    cases = 0
    for bits in (BITS, 4, 16, 24):
        g = max(32 // bits, 1)
        m_max, x, s, base, step, offset = kernel_inputs(D_FULL, bits, gen,
                                                       device)
        xr, sr = ops._pad_rows(x, g), ops._pad_rows(s, g)
        tr, orr = ops._pad_rows(step, g, 1.0), ops._pad_rows(offset, g)
        for st in (base, tr):
            w_k = fg.fused_encode(xr, sr, st, bits, m_max)
            w_p = ref.fused_encode_ref(xr, sr, st, bits, m_max)
            diff = int((w_k != w_p).sum())
            check(diff == 0, f"encode b={bits} words differ in {diff} lanes")
            # r = 1 summed message: s_eff = s + m_max
            se = sr + float(m_max)
            for off in (None, orr):
                y_k = fg.fused_decode(w_k, se, st, off, bits)
                y_p = ref.fused_decode_ref(w_p, se, st, off, bits)
                err = float((y_k - y_p).abs().max())
                check(err <= DECODE_ATOL, f"decode b={bits} err {err}")
                worst["fused_decode"] = max(worst["fused_decode"], err)
                cases += 1
                del y_k, y_p
            del w_k, w_p, se
        del x, s, step, offset, xr, sr, tr, orr
        torch.cuda.empty_cache()
        log(f"kernels b={bits}: words bitwise, decode within {DECODE_ATOL}")
    # one ragged size through ops, whose row padding the kernels see
    shape = (1000, 37)
    for bits in (BITS, 4, 16, 24):
        g = max(32 // bits, 1)
        m_max, x, s, base, step, offset = (
            t.reshape(shape) if isinstance(t, torch.Tensor) else t
            for t in kernel_inputs(math.prod(shape), bits, gen, device))
        se = s + float(m_max)
        for st in (base, step):
            st_r = st if isinstance(st, float) else ops._pad_rows(st, g, 1.0)
            w_k = ops.fused_pack_encode(x, s, st, bits, m_max)
            w_p = ref.fused_encode_ref(ops._pad_rows(x, g),
                                       ops._pad_rows(s, g), st_r, bits,
                                       m_max)
            check(bool((w_k == w_p).all()), f"ragged encode b={bits}")
            y_k = ops.fused_unpack_decode(w_k, se, st, offset, bits, shape)
            y_p = ref.fused_decode_ref(w_p, ops._pad_rows(se, g), st_r,
                                       ops._pad_rows(offset, g), bits)
            y_p = y_p.reshape(-1)[: math.prod(shape)].reshape(shape)
            err = float((y_k - y_p).abs().max())
            check(err <= DECODE_ATOL, f"ragged decode b={bits} err {err}")
            worst["fused_decode"] = max(worst["fused_decode"], err)
    log(f"kernels ragged (1000, 37): words bitwise, decode within "
        f"{DECODE_ATOL}; {cases} full-width decode cases")
    return worst


# ------------------------------------------------------------- phase 3
def client_targets(c: int, d: int, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(1_000 + c)
    return torch.randn(d, generator=gen, device=device) * 0.5


def run_mechanism(mech: str, sigma: float, device, sample_idx) -> dict:
    """ROUNDS rounds of FederatedAveraging at full width; returns the
    launch counts, the error sample and the round times."""
    import torch

    from repro_torch.dist import compress as dcompress
    from repro_torch.fl import federated
    from repro_torch.kernels import fused_agg as fg
    from repro_torch.runtime import protocol

    def client_grad(params, c, rnd):
        # least squares toward a per-client target drawn on the card
        return params - client_targets(c, params.numel(), device)

    cfg = federated.FLConfig(
        n_clients=N_CLIENTS, mechanism=mech, sigma=sigma, clip=CLIP, lr=1.0,
        seed=0, mech_kwargs=(("packed", True), ("msg_bits", BITS)))
    fa = federated.FederatedAveraging(cfg, client_grad, device=device)
    comp = fa.proto._comp()
    wire = dcompress.wire_bits_per_coord(comp, N_CLIENTS, size=D_FULL)
    check(wire == 8.0, f"{mech}: wire_bits_per_coord {wire} != 8")

    params = torch.zeros(D_FULL, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in fg.LAUNCHES:
        fg.LAUNCHES[k] = 0
    walls, split, errs = [], {}, []
    for rnd in range(ROUNDS):
        # the true mean of the clipped updates on the subsample
        p_s = params[sample_idx]
        mean = torch.zeros_like(p_s)
        for c in range(N_CLIENTS):
            t_s = client_targets(c, D_FULL, device)[sample_idx]
            mean += torch.clamp(p_s - t_s, -CLIP, CLIP)
        mean /= N_CLIENTS
        protocol.ROUND_TIMES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with protocol.timing(rnd == ROUNDS - 1):
            new, info = fa.round(params, rnd)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if rnd == ROUNDS - 1:
            split = dict(protocol.ROUND_TIMES)
        check(info["bits_per_coord"] == 8.0, f"{mech}: bits {info}")
        update = params[sample_idx] - new[sample_idx]  # lr = 1
        errs.append((update - mean).double().cpu())
        check(bool(torch.isfinite(new).all()), f"{mech}: non-finite params")
        params = new
    launches = dict(fg.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["fused_encode"] == ROUNDS * N_CLIENTS,
          f"{mech}: {launches['fused_encode']} encode launches, expected "
          f"{ROUNDS * N_CLIENTS}")
    check(launches["fused_decode"] == ROUNDS,
          f"{mech}: {launches['fused_decode']} decode launches, expected "
          f"{ROUNDS}")
    del params, new, fa
    torch.cuda.empty_cache()
    return {"launches": launches, "errs": errs, "walls": walls,
            "split": split, "peak_bytes": peak}


def check_error_laws(res_gauss, res_ih, sigma_g, sigma_ih) -> dict:
    import numpy as np

    out = {}
    for rnd, err in enumerate(res_gauss["errs"]):
        e = err.numpy()
        ks = ks_stat(e, sigma_g)
        thr = 1.95 / math.sqrt(len(e))
        log(f"aggregate_gaussian round {rnd}: KS {ks:.6f} (threshold "
            f"{thr:.6f}), std {e.std():.6f} vs sigma {sigma_g}")
        check(ks < thr, f"aggregate_gaussian round {rnd} fails KS: {ks}")
        out[f"gauss_ks_r{rnd}"] = ks
    half = sigma_ih * math.sqrt(3 * N_CLIENTS)
    for rnd, err in enumerate(res_ih["errs"]):
        e = err.numpy()
        std = float(e.std())
        m = float(np.abs(e).max())
        log(f"irwin_hall round {rnd}: max |err| {m:.6g} (support "
            f"{half:.6g}), std {std:.6g} vs sigma {sigma_ih}")
        # 1e-6 slack: the error is read back as params - new params
        check(m <= half + 1e-6, "irwin_hall error outside its support")
        check(abs(std - sigma_ih) <= 0.1 * sigma_ih,
              f"irwin_hall std {std} not within 10% of {sigma_ih}")
        out[f"ih_std_r{rnd}"] = std
    return out


# ------------------------------------------------------------- phase 4
def time_kernels(device, gen, rate: float) -> list:
    """Median times at the main path's shapes (d = D_FULL, b = 8): the
    aggregate configuration (array step, offset) and irwin_hall's
    (scalar step, no offset)."""
    import torch

    from repro_torch.kernels import fused_agg as fg
    from repro_torch.kernels import ops, ref

    g = 32 // BITS
    m_max, x, s, base, step, offset = kernel_inputs(D_FULL, BITS, gen, device)
    xr, sr = ops._pad_rows(x, g), ops._pad_rows(s, g)
    tr, orr = ops._pad_rows(step, g, 1.0), ops._pad_rows(offset, g)
    words = fg.fused_encode(xr, sr, tr, BITS, m_max)
    se = sr + float(m_max)
    n_el = xr.numel()
    f4, w4 = 4 * n_el, 4 * words.numel()
    rows = []
    for name, kind, kern, plain, nbytes in (
        ("fused_encode", "array step",
         lambda: fg.fused_encode(xr, sr, tr, BITS, m_max),
         lambda: ref.fused_encode_ref(xr, sr, tr, BITS, m_max),
         3 * f4 + w4),
        ("fused_encode", "scalar step",
         lambda: fg.fused_encode(xr, sr, base, BITS, m_max),
         lambda: ref.fused_encode_ref(xr, sr, base, BITS, m_max),
         2 * f4 + w4),
        ("fused_decode", "array step + offset",
         lambda: fg.fused_decode(words, se, tr, orr, BITS),
         lambda: ref.fused_decode_ref(words, se, tr, orr, BITS),
         w4 + 4 * f4),
        ("fused_decode", "scalar step",
         lambda: fg.fused_decode(words, se, base, None, BITS),
         lambda: ref.fused_decode_ref(words, se, base, None, BITS),
         w4 + 2 * f4),
    ):
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, reps=3)
        bound = nbytes / rate * 1e3
        rows.append({"name": name, "config": kind, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bytes": nbytes})
        log(f"{name} ({kind}): {ms:.4f} ms, bound {bound:.4f} ms "
            f"({nbytes / 1e9:.3f} GB at {rate / 1e12:.2f} TB/s, "
            f"{100 * bound / ms:.1f}% of it), plain {plain_ms:.4f} ms")
    del xr, sr, tr, orr, words, se, x, s, step, offset
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    rate = mem_rate(name)
    log(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # 1. build
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} s")
    for lib, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {lib}: {line.strip()}")

    # 2. kernels against their plain versions
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = compare_kernels(device, gen)

    # 3. the main path
    sample_idx = torch.arange(0, D_FULL, D_FULL // KS_SAMPLE,
                              device=device)[:KS_SAMPLE]
    sigma_g, sigma_ih = 0.25, 5e-3
    res_g = run_mechanism("aggregate_gaussian", sigma_g, device, sample_idx)
    res_ih = run_mechanism("irwin_hall", sigma_ih, device, sample_idx)
    laws = check_error_laws(res_g, res_ih, sigma_g, sigma_ih)
    for mech, res in (("aggregate_gaussian", res_g), ("irwin_hall", res_ih)):
        log(f"{mech}: launches {res['launches']}, round walls "
            f"{[round(w, 3) for w in res['walls']]} s, last round split "
            f"{json.dumps({k: round(v, 4) for k, v in res['split'].items()})}"
            f" s, peak memory {res['peak_bytes'] / 2**30:.2f} GiB")

    # 4. times
    rows = time_kernels(device, gen, rate)
    launches = {k: res_g["launches"][k] + res_ih["launches"][k]
                for k in res_g["launches"]}
    kernels = []
    for kname in ("fused_encode", "fused_decode"):
        main_row = next(r for r in rows if r["name"] == kname)
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    total = time.perf_counter() - t_start
    report = {"card": smi, "build_s": secs, "kernel_rows": rows,
              "rounds": {"aggregate_gaussian": {k: v for k, v in res_g.items()
                                                if k != "errs"},
                         "irwin_hall": {k: v for k, v in res_ih.items()
                                        if k != "errs"}},
              "laws": laws, "kernels": kernels, "seconds": total}
    out_dir = ROOT / "build"
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    except OSError as e:
        log(f"(report not written: {e})")
    log(f"total {total:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
