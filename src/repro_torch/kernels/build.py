"""Build the CUDA sources in ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (a git-ignored directory); the hash covers the
source, every shared header ``csrc/*.cuh`` and the flags, so an edited
source or header rebuilds and an unchanged one is loaded as it is.  The library is bound with ctypes.  A failed build
raises with nvcc's output.  Never built with ``--use_fast_math``: the
kernels' words must match the plain versions bitwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds each library's nvcc took in this process (0.0 when it was
# already built), and the compiler's report (registers, spills)
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists: (target, proc)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def build_all(names: Sequence[str] = ()) -> Dict[str, float]:
    """Build and load every library in ``names`` (default: every source
    in csrc/), one nvcc each, all started together.  Returns the seconds
    each build took."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if n not in _LIBS}
    for name, (target, job) in started.items():
        if job is not None:
            proc, tmp = job
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, target)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        else:
            BUILD_SECONDS.setdefault(name, 0.0)
        _LIBS[name] = ctypes.CDLL(str(target))
    return {n: BUILD_SECONDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]
