#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

The main path is one compressed FL round (``repro_torch.fl.federated``
over a ``RoundProtocol``) at the full width of the smallest model in the
registry, qwen1.5-0.5b: d = 463,987,712 coordinates, n = 4 clients,
clip 1.0, through three mechanisms: aggregate_gaussian and irwin_hall on
the packed wire (b = 8-bit fields, the fused_agg kernels) and
individual_shifted on the unpacked wire (the layered kernels); the
signed dither_pack kernels run on their own entry point,
``ops.dither_pack_encode`` / ``ops.dither_unpack_decode``.  Phases, each
fatal on failure:

  1. build every CUDA source of the port with nvcc (sm_90a), one nvcc
     per source, all started together;
  2. hold each kernel against its plain PyTorch version on the card at
     full width: fused_agg words bitwise and decode within 1e-6 for b in
     {8, 4, 16, 24}, scalar and array step, with and without offset;
     layered messages bitwise and decode within 1e-6 at sigma_client 0.5
     and 0.01; dither_pack words bitwise and decode equal for b in
     {4, 8, 16}, w = 0.05; and each on one ragged size;
  3. run each path with its kernels' launch counts set to 0 just before
     and read just after: FederatedAveraging for aggregate_gaussian
     (per-coordinate, sigma 0.25) and irwin_hall (sigma 5e-3), 2 packed
     rounds each, and individual_shifted (sigma 0.25), 2 unpacked rounds;
     one individual_direct round at 2^24 coordinates (no layered
     launches: the configuration picks the plain path); and the
     dither_pack entry point at full width; check the counts, the wire
     width or Elias-gamma bits, and the error law (KS against
     N(0, sigma^2) on a 2^20-coordinate subsample; IH support and std;
     the dither error inside [-w/2, w/2]);
  4. time each kernel (CUDA events, median of 10) beside its byte bound
     and its plain version, measure the card's device-to-device copy
     rate, and split each round's wall time by phase.

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
SIGMA_IND = 0.25  # individual_shifted: per-client sigma 0.25 * sqrt(4)
D_DIRECT = 1 << 24  # the individual_direct round
DP_W = 0.05  # dither_pack step
# elements per chunk when a plain version runs beside a kernel at full
# width (its f64 fused multiply-adds would not fit the card at once)
PLAIN_CHUNK = 1 << 24
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {  # name: (source, replaced TPU kernel)
    "fused_encode": ("fused_agg.cu", "src/repro/kernels/fused_agg.py:89"),
    "fused_decode": ("fused_agg.cu", "src/repro/kernels/fused_agg.py:115"),
    "dither_pack": ("dither_pack.cu",
                    "src/repro/kernels/dither_pack.py:56"),
    "unpack_decode": ("dither_pack.cu",
                      "src/repro/kernels/dither_pack.py:75"),
    "layered_encode": ("layered.cu",
                       "src/repro/kernels/layered_encode.py:67"),
    "layered_decode": ("layered.cu",
                       "src/repro/kernels/layered_encode.py:72"),
}
# device-memory rate (bytes/s) and f32 rate outside the tensor cores
# (flop/s) by card name, from NVIDIA's data sheets
_RATES = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
          ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))
# f32 operations per coordinate of each kernel, counted from its source
# (a fused multiply-add counts 2; the layered kernels' log polynomial and
# square root dominate theirs)
FLOPS_PER_COORD = {"fused_encode": 5, "fused_decode": 3, "dither_pack": 5,
                   "unpack_decode": 2, "layered_encode": 74,
                   "layered_decode": 76}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


def card_rates(name: str) -> tuple:
    """(bytes/s, f32 flop/s) of the card named ``name``."""
    for tag, mem, flops in _RATES:
        if tag in name:
            return mem, flops
    raise RuntimeError(f"no rates known for card {name!r}: add them to "
                       f"_RATES")


def timed_row(name: str, kind: str, kern, plain, nbytes: int, coords: int,
              rates: tuple) -> dict:
    """Median kernel time (CUDA events, 10 runs) and plain-version time
    (3 runs) beside the bound: the larger of the bytes (each input read
    once, each output written once) over the memory rate and the f32
    operations over the f32 rate.  ``rates`` = (data-sheet bytes/s, f32
    flop/s, measured copy bytes/s); the bytes also go over the measured
    copy rate."""
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, reps=3)
    bytes_ms = nbytes / rates[0] * 1e3
    ops_ms = FLOPS_PER_COORD[name] * coords / rates[1] * 1e3
    bound = max(bytes_ms, ops_ms)
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    copy_ms = nbytes / rates[2] * 1e3
    log(f"{name} ({kind}): {ms:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes / 1e9:.3f} GB at {rates[0] / 1e12:.2f} TB/s; "
        f"operations {ops_ms:.4f} ms), {100 * bound / ms:.1f}% of it, "
        f"{100 * copy_ms / ms:.1f}% of the measured copy rate; plain "
        f"{plain_ms:.4f} ms")
    return {"name": name, "config": kind, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "ops_ms": ops_ms, "copy_ms": copy_ms}


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


def _row_chunks(n_rows: int, fields: int = 1):
    """Row slices of PLAIN_CHUNK coordinates (rows of fields * 128)."""
    step = max(PLAIN_CHUNK // (128 * fields), 1)
    return [slice(r, r + step) for r in range(0, n_rows, step)]


def compare_layered(device, gen) -> dict:
    """The layered kernels against their plain versions at full width
    (the plain version in chunks of PLAIN_CHUNK), at sigma_client 0.5 (the
    individual_shifted round: 0.25 * sqrt(4)) and 0.01, and on a ragged
    size through ops.  Layers span (0, peak)."""
    import torch

    from repro_torch.kernels import layered_encode as le
    from repro_torch.kernels import ops, ref

    worst = {"layered_encode": 0.0, "layered_decode": 0.0}
    for sigma in (2 * SIGMA_IND, 0.01):
        peak = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
        x = torch.randn(D_FULL, generator=gen, device=device) * (3 * sigma)
        u = torch.rand(D_FULL, generator=gen, device=device)
        layer = torch.rand(D_FULL, generator=gen, device=device) * peak
        xr, ur, lr = (t.view(-1, 128) for t in (x, u, layer))
        m = le.layered_encode(xr, ur, lr, sigma)
        y = le.layered_decode(m, ur, lr, sigma)
        for sl in _row_chunks(xr.shape[0]):
            mp = ref.layered_encode_ref(xr[sl], ur[sl], lr[sl], sigma)
            diff = int((m[sl] != mp).sum())
            check(diff == 0, f"layered_encode sigma={sigma}: {diff} differ")
            yp = ref.layered_decode_ref(m[sl], ur[sl], lr[sl], sigma)
            err = float((y[sl] - yp).abs().max())
            check(err <= DECODE_ATOL, f"layered_decode sigma={sigma} {err}")
            worst["layered_decode"] = max(worst["layered_decode"], err)
        del x, u, layer, xr, ur, lr, m, y
        torch.cuda.empty_cache()
        log(f"layered sigma={sigma}: messages bitwise, decode within "
            f"{DECODE_ATOL}")
    shape = (1000, 37)
    x = torch.randn(shape, generator=gen, device=device) * 1.5
    u = torch.rand(shape, generator=gen, device=device)
    layer = torch.rand(shape, generator=gen, device=device) * 0.79
    m = ops.layered_encode(x, u, layer, 0.5)
    rows = [ops._rows(t) for t in (x, u, layer)]
    mp = ref.layered_encode_ref(*rows, 0.5).reshape(-1)[:37000]
    check(bool((m.reshape(-1) == mp).all()), "ragged layered_encode")
    y = ops.layered_decode(m, u, layer, 0.5)
    yp = ref.layered_decode_ref(ops._rows(m), rows[1], rows[2], 0.5)
    err = float((y.reshape(-1) - yp.reshape(-1)[:37000]).abs().max())
    check(err <= DECODE_ATOL, f"ragged layered_decode {err}")
    log("layered ragged (1000, 37): messages bitwise, decode within "
        f"{DECODE_ATOL}")
    return worst


def compare_dither_pack(device, gen) -> dict:
    """The signed dither_pack kernels against their plain versions at full
    width for b in {4, 8, 16}, w = DP_W, and on a ragged size."""
    import torch

    from repro_torch.kernels import dither_pack as dp
    from repro_torch.kernels import ops, ref

    worst = {"dither_pack": 0.0, "unpack_decode": 0.0}
    for bits in (8, 4, 16):
        g = 32 // bits
        x = torch.randn(D_FULL, generator=gen, device=device) * 0.1
        s = torch.rand(D_FULL, generator=gen, device=device) - 0.5
        xr, sr = ops._pad_rows(x, g), ops._pad_rows(s, g)
        words = dp.dither_pack(xr, sr, DP_W, bits)
        y = dp.unpack_decode(words, sr, DP_W, bits)
        for sl in _row_chunks(xr.shape[0], g):
            wp = ref.dither_pack_ref(xr[sl], sr[sl], DP_W, bits)
            diff = int((words[sl] != wp).sum())
            check(diff == 0, f"dither_pack b={bits}: {diff} words differ")
            yp = ref.unpack_decode_ref(words[sl], sr[sl], DP_W, bits)
            err = float((y[sl] - yp).abs().max())
            check(err == 0.0, f"unpack_decode b={bits}: {err}")
        del x, s, xr, sr, words, y
        torch.cuda.empty_cache()
        log(f"dither_pack b={bits}: words bitwise, decode equal")
    shape = (1000, 37)
    x = torch.randn(shape, generator=gen, device=device) * 0.2
    s = torch.rand(shape, generator=gen, device=device) - 0.5
    for bits in (4, 8, 16):
        g = 32 // bits
        words, _ = ops.dither_pack_encode(x, s, DP_W, bits=bits)
        wp = ref.dither_pack_ref(ops._pad_rows(x, g), ops._pad_rows(s, g),
                                 DP_W, bits)
        check(bool((words == wp).all()), f"ragged dither_pack b={bits}")
        y = ops.dither_unpack_decode(words, s, DP_W, bits, shape)
        yp = ref.unpack_decode_ref(wp, ops._pad_rows(s, g), DP_W, bits)
        check(bool((y.reshape(-1) == yp.reshape(-1)[:37000]).all()),
              f"ragged unpack_decode b={bits}")
    log("dither_pack ragged (1000, 37): words bitwise, decode equal")
    return worst


# ------------------------------------------------------------- phase 3
def reset_launches() -> None:
    from repro_torch.kernels import dither_pack as dp
    from repro_torch.kernels import fused_agg as fg
    from repro_torch.kernels import layered_encode as le

    for counts in (fg.LAUNCHES, dp.LAUNCHES, le.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from repro_torch.kernels import dither_pack as dp
    from repro_torch.kernels import fused_agg as fg
    from repro_torch.kernels import layered_encode as le

    return {**fg.LAUNCHES, **dp.LAUNCHES, **le.LAUNCHES}


def client_targets(c: int, d: int, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(1_000 + c)
    return torch.randn(d, generator=gen, device=device) * 0.5


def run_mechanism(mech: str, sigma: float, device, sample_idx, expect: dict,
                  d: int = D_FULL, rounds: int = ROUNDS) -> dict:
    """``rounds`` rounds of FederatedAveraging at width ``d``, the packed
    wire for the homomorphic mechanisms and the unpacked one otherwise;
    checks the launch counts against ``expect`` (every other kernel: 0)
    and returns them, the error sample, the round times and the bits."""
    import torch

    from repro_torch.dist import compress as dcompress
    from repro_torch.fl import federated
    from repro_torch.runtime import protocol

    def client_grad(params, c, rnd):
        # least squares toward a per-client target drawn on the card
        return params - client_targets(c, params.numel(), device)

    packed = mech in dcompress.HOMOMORPHIC
    kwargs = (("packed", True), ("msg_bits", BITS)) if packed else ()
    cfg = federated.FLConfig(
        n_clients=N_CLIENTS, mechanism=mech, sigma=sigma, clip=CLIP, lr=1.0,
        seed=0, mech_kwargs=kwargs)
    fa = federated.FederatedAveraging(cfg, client_grad, device=device)
    if packed:
        comp = fa.proto._comp()
        wire = dcompress.wire_bits_per_coord(comp, N_CLIENTS, size=d)
        check(wire == 8.0, f"{mech}: wire_bits_per_coord {wire} != 8")

    params = torch.zeros(d, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, split, errs, bits = [], {}, [], []
    for rnd in range(rounds):
        # the true mean of the clipped updates on the subsample
        p_s = params[sample_idx]
        mean = torch.zeros_like(p_s)
        for c in range(N_CLIENTS):
            t_s = client_targets(c, d, device)[sample_idx]
            mean += torch.clamp(p_s - t_s, -CLIP, CLIP)
        mean /= N_CLIENTS
        protocol.ROUND_TIMES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with protocol.timing(rnd == rounds - 1):
            new, info = fa.round(params, rnd)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if rnd == rounds - 1:
            split = dict(protocol.ROUND_TIMES)
        bits.append(info["bits_per_coord"])
        if packed:
            check(info["bits_per_coord"] == 8.0, f"{mech}: bits {info}")
        else:  # measured Elias-gamma length
            check(1.0 <= info["bits_per_coord"] < 32.0, f"{mech}: {info}")
        update = params[sample_idx] - new[sample_idx]  # lr = 1
        errs.append((update - mean).double().cpu())
        check(bool(torch.isfinite(new).all()), f"{mech}: non-finite params")
        params = new
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for k, v in launches.items():
        want = expect.get(k, 0)
        check(v == want, f"{mech}: {v} {k} launches, expected {want}")
    del params, new, fa
    torch.cuda.empty_cache()
    return {"launches": launches, "errs": errs, "walls": walls,
            "split": split, "peak_bytes": peak, "bits": bits}


def run_dither_pack(device, gen) -> dict:
    """The dither_pack path: its entry points ops.dither_pack_encode /
    ops.dither_unpack_decode at full width, b = 8, w = DP_W, with the
    launch counts set to 0 just before and read just after; the error of
    the round trip is the dither's, inside [-w/2, w/2] with std
    w / sqrt(12)."""
    import torch

    from repro_torch.kernels import ops

    x = torch.randn(D_FULL, generator=gen, device=device) * 0.3
    s = torch.rand(D_FULL, generator=gen, device=device) - 0.5
    torch.cuda.synchronize()
    reset_launches()
    words, numel = ops.dither_pack_encode(x, s, DP_W, bits=BITS)
    y = ops.dither_unpack_decode(words, s, DP_W, BITS, x.shape)
    torch.cuda.synchronize()
    launches = read_launches()
    for k, v in launches.items():
        want = 1 if k in ("dither_pack", "unpack_decode") else 0
        check(v == want, f"dither_pack path: {v} {k} launches")
    wire = 32.0 * words.numel() / numel
    check(wire == 8.0, f"dither_pack wire {wire} bits per coordinate")
    err = y - x
    emax, estd = float(err.abs().max()), float(err.std())
    check(emax <= DP_W / 2 + 1e-6, f"dither_pack error {emax} > w/2")
    check(abs(estd - DP_W / math.sqrt(12)) < 0.02 * DP_W,
          f"dither_pack error std {estd}")
    log(f"dither_pack path: launches {launches}, wire {wire} bits, max "
        f"|err| {emax:.6g} (w/2 = {DP_W / 2}), std {estd:.6g} "
        f"(w/sqrt(12) = {DP_W / math.sqrt(12):.6g})")
    del x, s, words, y, err
    torch.cuda.empty_cache()
    return {"launches": launches, "max_err": emax, "std": estd}


def check_gaussian_law(mech: str, res: dict, sigma: float) -> dict:
    """KS of each round's error against N(0, sigma^2), below 1.95/sqrt(N)
    on the subsample."""
    out = {}
    for rnd, err in enumerate(res["errs"]):
        e = err.numpy()
        ks = ks_stat(e, sigma)
        thr = 1.95 / math.sqrt(len(e))
        log(f"{mech} round {rnd}: KS {ks:.6f} (threshold {thr:.6f}), std "
            f"{e.std():.6f} vs sigma {sigma}")
        check(ks < thr, f"{mech} round {rnd} fails KS: {ks}")
        out[f"{mech}_ks_r{rnd}"] = ks
    return out


def check_error_laws(res_gauss, res_ih, sigma_g, sigma_ih) -> dict:
    import numpy as np

    out = check_gaussian_law("aggregate_gaussian", res_gauss, sigma_g)
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
def time_kernels(device, gen, rates: tuple) -> list:
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
        rows.append(timed_row(name, kind, kern, plain, nbytes, n_el,
                              rates))
    del xr, sr, tr, orr, words, se, x, s, step, offset
    torch.cuda.empty_cache()
    return rows


def time_new_kernels(device, gen, rates: tuple) -> list:
    """Median times of the layered kernels (sigma_client 0.5, the
    individual_shifted round's) and the dither_pack kernels (b = 8) at
    full width, beside their byte bounds and their plain versions (run
    over the same input in chunks of PLAIN_CHUNK, median of 3)."""
    import torch

    from repro_torch.kernels import dither_pack as dp
    from repro_torch.kernels import layered_encode as le
    from repro_torch.kernels import ops, ref

    rows = []

    def add(name, kind, kern, plain, nbytes):
        rows.append(timed_row(name, kind, kern, plain, nbytes, D_FULL,
                              rates))

    sigma = 2 * SIGMA_IND
    peak = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
    xr = (torch.randn(D_FULL, generator=gen, device=device)
          * (3 * sigma)).view(-1, 128)
    ur = torch.rand(D_FULL, generator=gen, device=device).view(-1, 128)
    lr = (torch.rand(D_FULL, generator=gen, device=device)
          * peak).view(-1, 128)
    m = le.layered_encode(xr, ur, lr, sigma)
    chunks = _row_chunks(xr.shape[0])

    def plain_enc():
        for sl in chunks:
            ref.layered_encode_ref(xr[sl], ur[sl], lr[sl], sigma)

    def plain_dec():
        for sl in chunks:
            ref.layered_decode_ref(m[sl], ur[sl], lr[sl], sigma)

    add("layered_encode", f"sigma {sigma}",
        lambda: le.layered_encode(xr, ur, lr, sigma), plain_enc, 16 * D_FULL)
    add("layered_decode", f"sigma {sigma}",
        lambda: le.layered_decode(m, ur, lr, sigma), plain_dec, 16 * D_FULL)
    del xr, ur, lr, m
    torch.cuda.empty_cache()

    g = 32 // BITS
    xr = ops._pad_rows(torch.randn(D_FULL, generator=gen, device=device)
                       * 0.1, g)
    sr = ops._pad_rows(torch.rand(D_FULL, generator=gen, device=device)
                       - 0.5, g)
    words = dp.dither_pack(xr, sr, DP_W, BITS)
    chunks = _row_chunks(xr.shape[0], g)

    def plain_pack():
        for sl in chunks:
            ref.dither_pack_ref(xr[sl], sr[sl], DP_W, BITS)

    def plain_unpack():
        for sl in chunks:
            ref.unpack_decode_ref(words[sl], sr[sl], DP_W, BITS)

    nb = 8 * D_FULL + 4 * words.numel()
    add("dither_pack", f"b = {BITS}",
        lambda: dp.dither_pack(xr, sr, DP_W, BITS), plain_pack, nb)
    add("unpack_decode", f"b = {BITS}",
        lambda: dp.unpack_decode(words, sr, DP_W, BITS), plain_unpack, nb)
    del xr, sr, words
    torch.cuda.empty_cache()
    return rows


def copy_rate(device) -> dict:
    """The card's achievable device-to-device rate: ``copy_`` of a
    4.29 GB f32 tensor, CUDA events, median of 10; bytes read + written
    over the time."""
    import torch

    src = torch.empty(1 << 30, dtype=torch.float32, device=device)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    nbytes = 2 * src.numel() * 4
    rate = nbytes / (ms * 1e-3)
    log(f"copy_ of {src.numel() * 4 / 1e9:.3f} GB: {ms:.4f} ms, "
        f"{rate / 1e12:.4f} TB/s read + write")
    del src, dst
    torch.cuda.empty_cache()
    return {"ms": ms, "bytes": nbytes, "rate": rate}


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
    rates = card_rates(name)
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
    worst.update(compare_layered(device, gen))
    worst.update(compare_dither_pack(device, gen))
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    # 3. the main path: each path with its launch counts
    from repro_torch.dist import compress as dcompress

    sample_idx = torch.arange(0, D_FULL, D_FULL // KS_SAMPLE,
                              device=device)[:KS_SAMPLE]
    sigma_g, sigma_ih = 0.25, 5e-3
    fused = {"fused_encode": ROUNDS * N_CLIENTS, "fused_decode": ROUNDS}
    layered = {"layered_encode": ROUNDS * N_CLIENTS,
               "layered_decode": ROUNDS * N_CLIENTS}
    res = {
        "aggregate_gaussian": run_mechanism(
            "aggregate_gaussian", sigma_g, device, sample_idx, fused),
        "irwin_hall": run_mechanism("irwin_hall", sigma_ih, device,
                                    sample_idx, fused),
        "individual_shifted": run_mechanism(
            "individual_shifted", SIGMA_IND, device, sample_idx, layered),
    }
    laws = check_error_laws(res["aggregate_gaussian"], res["irwin_hall"],
                            sigma_g, sigma_ih)
    laws.update(check_gaussian_law("individual_shifted",
                                   res["individual_shifted"], SIGMA_IND))
    fixed = dcompress.message_bits(dcompress.CompressionConfig(
        mechanism="layered_shifted", sigma=SIGMA_IND, clip=CLIP), N_CLIENTS,
        device=device)
    log(f"individual_shifted: Elias-gamma bits per coordinate "
        f"{res['individual_shifted']['bits']} (measured); the reference's "
        f"message_bits (fixed-length code, |Supp M| <= 2 + t / eta) "
        f"{fixed}")
    # the configuration's dispatch: direct layering runs plain PyTorch
    direct_idx = torch.arange(0, D_DIRECT, D_DIRECT // KS_SAMPLE,
                              device=device)[:KS_SAMPLE]
    res["individual_direct"] = run_mechanism(
        "individual_direct", SIGMA_IND, device, direct_idx, {},
        d=D_DIRECT, rounds=1)
    laws.update(check_gaussian_law("individual_direct",
                                   res["individual_direct"], SIGMA_IND))
    for mech, r in res.items():
        log(f"{mech}: launches {r['launches']}, round walls "
            f"{[round(w, 3) for w in r['walls']]} s, last round split "
            f"{json.dumps({k: round(v, 4) for k, v in r['split'].items()})}"
            f" s, peak memory {r['peak_bytes'] / 2**30:.2f} GiB")
    dpath = run_dither_pack(device, gen)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # 4. times
    copy = copy_rate(device)
    log(f"copy rate {copy['rate'] / 1e12:.4f} TB/s beside the data sheet's "
        f"{rates[0] / 1e12:.2f} TB/s")
    rates = rates + (copy["rate"],)
    rows = time_kernels(device, gen, rates) + time_new_kernels(device, gen,
                                                               rates)
    launches = {k: sum(r["launches"][k] for r in res.values())
                + dpath["launches"][k] for k in KERNELS}
    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        main_row = next(r for r in rows if r["name"] == kname)
        kernels.append({
            "name": kname, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None})
    total = time.perf_counter() - t_start
    report = {"card": smi, "build_s": secs, "kernel_rows": rows,
              "copy": copy, "dither_pack_path": dpath,
              "message_bits_layered_shifted": fixed,
              "rounds": {m: {k: v for k, v in r.items() if k != "errs"}
                         for m, r in res.items()},
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
