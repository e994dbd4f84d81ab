"""Compare two versions of the flash-attention backward kernels
(``csrc/flash_attention_bwd_sm90.cu``, bf16, and
``csrc/flash_attention_bwd_f32_sm90.cu``, f32) on the card, in one
process.

    PYTHONPATH=src python3 tools/torch_flash_bwd_ab.py OTHER/src/repro_torch/kernels/csrc

``OTHER/...`` is another tree's kernel sources (for example the parent
commit unpacked with ``git archive``), compiled here with the build's
flags and that directory's headers; they are "P", this tree's "C".  The
bf16 kernels are held against ``ref.flash_attention_bwd_ref`` on
``chip_smoke.BWD_DRIFT_CASES`` (their own generator, seeded with
``chip_smoke.DRIFT_SEED``: both kernels take the same inputs) under
``chip_smoke.py``'s bf16 bars, and run twice (bitwise equal or not); per
output it prints the count over the bar, the worst diff over its bar (at
most 1 passes), the share within one ulp + 2e-5 max|g| and the share
equal to the plain version.  Then both kernels of each dtype are timed
(``chip_smoke.batched_ms``, 5 calls a mean) at every row of
``chip_smoke.BWD_TIMED``, in turns P C C P.  Prints ptxas' report of the
other tree's builds, one JSON line per case and per timed row, and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

NAMES = ("flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90")


def _ptxas(text: str) -> list:
    return [line.strip() for line in text.splitlines()
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "C75"))]


def build_other(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build

    out = build.BUILD_DIR / "ab" / f"{src.stem}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build._nvcc(), *build.FLAGS, "-I", str(src.parent), "-o", str(out),
         str(src)], capture_output=True, text=True)
    for line in _ptxas(proc.stdout + proc.stderr):
        print(f"ptxas P: {line}")
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


def hold(case, got, again, want, do, colsum) -> dict:
    """chip_smoke's bf16 bars for each of dq, dk, dv."""
    import chip_smoke as cs

    row = {}
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        diff = (a.float() - b.float()).abs()
        gmax = float(b.float().abs().max())
        ulp = cs.bf16_ulp(b)
        slack = cs.BWD_REL * gmax
        if name == "dv":
            slack += cs.BF16_P_BAR * float(do.float().abs().max()) * colsum
        row[name] = {
            "over": int((diff > ulp + slack).sum()),
            "max_abs_err": float(diff.max()),
            "bar_ratio": float((diff / (ulp + slack)).max()),
            "share_within_ulp": float((diff <= ulp + cs.BWD_REL * gmax)
                                      .float().mean()),
            "share_equal": float((a == b).float().mean()),
            "two_runs_equal": bool(c.equal(a))}
    return row


def main(other: str) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all(["flash_attention_sm90", *NAMES])
    libs = {name: {"P": build_other(Path(other) / f"{name}.cu"),
                   "C": build._LIBS[name]} for name in NAMES}
    dev = torch.device("cuda", 0)

    def use(tag):
        for name in NAMES:
            build._LIBS[name] = libs[name][tag]

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.DRIFT_SEED)
    for case in cs.BWD_DRIFT_CASES:
        causal = case[6]
        q, k, v, o, lse, do = cs.bwd_inputs(case, torch.bfloat16, gen, dev)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        colsum = cs.p_colsum_max(q, k, lse, causal)
        for tag in "PC":
            use(tag)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            print(json.dumps({"case": list(case), "kernel": tag,
                              **hold(case, got, again, want, do, colsum)}),
                  flush=True)
            del got, again
        del q, k, v, o, lse, do, want
        torch.cuda.empty_cache()

    tgen = torch.Generator(device=dev)
    tgen.manual_seed(0)
    for row in cs.BWD_TIMED:
        B, T, S, H, HK, D, dt = row[:7]
        window, causal = cs.case_window(row), cs.timed_causal(row)
        case = (B, T, S, H, HK, D, causal, window)
        q, k, v, o, lse, do = cs.bwd_inputs(case, getattr(torch, dt), tgen,
                                            dev)
        ms = {"P": [], "C": []}
        for tag in "PCCP":
            use(tag)
            ms[tag].append(cs.batched_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal, window=window), n=5, reps=3))
        print(json.dumps({"timed": list(case), "dtype": dt, "ms": ms}),
              flush=True)
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    use("C")
    print(smi)


if __name__ == "__main__":
    main(sys.argv[1])
