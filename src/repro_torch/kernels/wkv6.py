"""Wrappers of the CUDA kernels in ``csrc/wkv6.cu``: the RWKV-6 time
recurrence, a serial step kernel and a chunked forward and backward.  They
have no Pallas counterpart: the JAX package runs the recurrence as a
compiled ``lax.scan`` (``repro.models.rwkv6._wkv_scan`` and its one-token
decode).

Per (batch, head), with the K x K f32 state S before step t:

    kv = k_t^T v_t;   y_t = r_t (S + diag(u) kv);   S <- S diag_rows(w_t) + kv

* ``wkv6_step`` (kernel ``wkv6_step``): the steps one by one, its states
  bitwise the plain version's.  It runs the decode step (T = 1 with a
  state).
* ``wkv6_fwd`` (kernel ``wkv6_fwd``, three launches): the chunked forward
  of every other call (T > 1: the scan path and training): y, the final
  state and the state entering every ``ref.WKV_CHUNK``-step chunk, which
  the backward starts from.
* ``wkv6_bwd`` (kernel ``wkv6_bwd``, three launches): dr, dk, dv, dw, du
  and the first state's gradient in the chunked form; no atomics (du is
  summed here from per-chunk partials), so every run gives the same bits.

``uses_step(T, state)`` is the rule between the two forwards; a kernel
that fails to build or launch raises, whichever it is.  ``ref.
wkv6_chunked_ref`` / ``wkv6_chunked_bwd_ref`` are the chunked kernels'
algorithm in plain PyTorch (the tests' and chip_smoke.py's mirror).

r, k, v (B, T, H, K) in one dtype (f32 or bf16), w of the same shape in
f32 or bf16 (the JAX model's scan rounds its decay to the compute dtype,
its decode keeps it f32), u (H, K) f32, states (B, H, K, K) f32, K in
{16, 64}; y and every gradient come out in f32.  Each wrapper checks
its inputs, allocates its outputs and scratch, launches on the current
stream, raises if the launch failed, and adds one to its kernel's
``LAUNCHES`` entry.  The plain versions are ``ref.wkv6_ref`` /
``ref.wkv6_bwd_ref``.  ``Wkv6`` is the autograd function over them: the
kernels for CUDA tensors, the plain versions for CPU tensors, nothing in
between; ``ops.wkv6`` goes through it.  On meta tensors (the dry run,
``launch.dryrun``) the wrappers check and allocate as on the card and, in
place of the launch, charge the kernel's cost to ``kernels.meta``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta, ref

# rwkv6's full heads, and its smoke config's
HEAD_DIMS = (16, 64)
DTYPES = (torch.float32, torch.bfloat16)

# launches since the last reset (a plain dict of ints)
LAUNCHES = {"wkv6_fwd": 0, "wkv6_bwd": 0, "wkv6_step": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_TYPED: set = set()


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    if id(lib) not in _TYPED:
        lib.wkv6_step_launch.argtypes = [_P] * 9 + [_I] * 6 + [_P]
        lib.wkv6_step_launch.restype = _I
        lib.wkv6_fwd_launch.argtypes = [_P] * 11 + [_I] * 6 + [_P]
        lib.wkv6_fwd_launch.restype = _I
        lib.wkv6_bwd_launch.argtypes = [_P] * 17 + [_I] * 6 + [_P]
        lib.wkv6_bwd_launch.restype = _I
        lib.wkv6_grad_smem_bytes.argtypes = [_I]
        lib.wkv6_grad_smem_bytes.restype = ctypes.c_size_t
        for fn in (lib.wkv6_chunk, lib.wkv6_sub):
            fn.argtypes = []
            fn.restype = _I
        got = (lib.wkv6_chunk(), lib.wkv6_sub())
        if got != (ref.WKV_CHUNK, ref.WKV_SUB):
            raise RuntimeError(f"wkv6 library's (chunk, sub-chunk) {got}, "
                               f"the plain mirror's "
                               f"{(ref.WKV_CHUNK, ref.WKV_SUB)}")
        _TYPED.add(id(lib))
    return lib


def n_chunks(T: int) -> int:
    return -(-T // ref.WKV_CHUNK)


def uses_step(T: int, state) -> bool:
    """The rule between the forwards: the step kernel for one step from a
    state (the decode step, where a chunk buys nothing and the states stay
    bitwise the plain version's), the chunked kernels for every other
    call."""
    return T == 1 and state is not None


def check_shapes(r, k, v, w, u):
    """(B, T, H, K) of a supported call, else raise."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, K), got {tuple(r.shape)}")
    B, T, H, K = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != (B, T, H, K):
            raise ValueError(f"{name} is {tuple(t.shape)}, r "
                             f"{(B, T, H, K)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u is {tuple(u.shape)}, expected {(H, K)}")
    if K not in HEAD_DIMS:
        raise ValueError(f"head dim {K} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if T < 1 or B < 1:
        raise ValueError(f"empty input: B={B}, T={T}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one dtype of {DTYPES}, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype not in DTYPES:
        raise TypeError(f"w must be one of {DTYPES}, got {w.dtype}")
    if r.dtype == torch.float32 and w.dtype != torch.float32:
        raise TypeError(f"f32 r, k, v take an f32 decay w, got {w.dtype}")
    return B, T, H, K


def _check_cuda(ref_t, named) -> None:
    """Every tensor on ref_t's device, CUDA (or meta: the dry run), and
    contiguous."""
    for name, t in named:
        if t is None:
            continue
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"{name}: wkv6 launches on CUDA, got "
                             f"{t.device}")
        if t.device != ref_t.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{ref_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_f32(name, t, shape) -> None:
    if t is not None and (t.dtype != torch.float32
                          or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} float32")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t):
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (the chunked kernels read 16 bytes a load)."""
    return (t if t.device.type == "meta" or t.data_ptr() % 16 == 0
            else t.clone())


def _check_launch(name: str, err: int) -> None:
    if err == -2:
        raise ValueError(f"{name}: no kernel for this head dim and "
                         f"dtypes")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _fwd_args(r, k, v, w, u, state):
    """A forward's checks and outputs: (B, T, H, K, y, the final state)."""
    B, T, H, K = check_shapes(r, k, v, w, u)
    _check_cuda(r, (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)))
    _check_f32("u", u, (H, K))
    _check_f32("state", state, (B, H, K, K))
    y = torch.empty((B, T, H, K), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    return B, T, H, K, y, s_out


def _chunk_scratch(B, H, nc, K, device):
    """The chunk-level stages' f64 scratch: each chunk's sum (B, H, nc, K,
    K) and decay (B, H, nc, K)."""
    return (torch.empty((B, H, nc, K, K), dtype=torch.float64, device=device),
            torch.empty((B, H, nc, K), dtype=torch.float64, device=device))


def _flags(r, w):
    return int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16)


def wkv6_step(r, k, v, w, u, state=None, *, chunks: bool = False):
    """Launch the serial walk: (y (B, T, H, K) f32, the final state (B, H,
    K, K) f32), and with ``chunks`` also the state before every
    ``ref.WKV_CHUNK``-th step, (B, H, ceil(T / WKV_CHUNK), K, K) f32."""
    B, T, H, K, y, s_out = _fwd_args(r, k, v, w, u, state)
    cs = (torch.empty((B, H, n_chunks(T), K, K), dtype=torch.float32,
                      device=r.device) if chunks else None)
    if r.device.type == "meta":
        # 5 K^2 a (b, t, h): K times r's elements
        meta.charge("wkv6_step", 5 * K * r.numel(), (r, k, v, w, u, state),
                    (y, s_out, cs))
        return (y, s_out, cs) if chunks else (y, s_out)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().wkv6_step_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), _ptr(state), y.data_ptr(), s_out.data_ptr(),
            _ptr(cs), B, T, H, K, *_flags(r, w), stream)
    _check_launch("wkv6_step", err)
    LAUNCHES["wkv6_step"] += 1
    return (y, s_out, cs) if chunks else (y, s_out)


def wkv6_fwd(r, k, v, w, u, state=None, *, chunks: bool = False):
    """Launch the chunked forward: (y (B, T, H, K) f32, the final state
    (B, H, K, K) f32), and with ``chunks`` also the state entering every
    ``ref.WKV_CHUNK``-step chunk, (B, H, ceil(T / WKV_CHUNK), K, K) f32.
    The chunk states and the f64 scratch are made without ``chunks`` too:
    the chunk pass hands the states to the output stage, which starts
    each chunk from its own."""
    B, T, H, K, y, s_out = _fwd_args(r, k, v, w, u, state)
    r, k, v, w = (_aligned(t) for t in (r, k, v, w))
    nc = n_chunks(T)
    cs = torch.empty((B, H, nc, K, K), dtype=torch.float32, device=r.device)
    dsum, F = _chunk_scratch(B, H, nc, K, r.device)
    if r.device.type == "meta":
        meta.charge("wkv6_fwd", 5 * K * r.numel(), (r, k, v, w, u, state),
                    (y, s_out, cs))
        return (y, s_out, cs) if chunks else (y, s_out)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().wkv6_fwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), _ptr(state), y.data_ptr(), s_out.data_ptr(),
            cs.data_ptr(), dsum.data_ptr(), F.data_ptr(), B, T, H, K,
            *_flags(r, w), stream)
    _check_launch("wkv6_fwd", err)
    LAUNCHES["wkv6_fwd"] += 1
    return (y, s_out, cs) if chunks else (y, s_out)


def wkv6_bwd(r, k, v, w, u, dy, chunks, dstate=None, *,
             want_dstate: bool = False):
    """Launch the chunked backward from dy (B, T, H, K) f32, the
    forward's ``chunks`` and the final state's gradient ``dstate`` (or
    None: zero): (dr, dk, dv, dw (B, T, H, K), du (H, K), dS0 (B, H, K, K)
    or None without ``want_dstate``), all f32."""
    B, T, H, K = check_shapes(r, k, v, w, u)
    _check_cuda(r, (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("dy", dy), ("chunks", chunks), ("dstate", dstate)))
    nc = n_chunks(T)
    _check_f32("u", u, (H, K))
    _check_f32("dy", dy, (B, T, H, K))
    _check_f32("chunks", chunks, (B, H, nc, K, K))
    _check_f32("dstate", dstate, (B, H, K, K))
    r, k, v, w, dy, chunks = (_aligned(t) for t in (r, k, v, w, dy, chunks))
    dr, dk, dv, dw = (torch.empty((B, T, H, K), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du_part = torch.empty((B, H, nc, K), dtype=torch.float32,
                          device=r.device)
    ds0 = (torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
           if want_dstate else None)
    after = torch.empty((B, H, nc, K, K), dtype=torch.float32,
                        device=r.device)
    dsum, F = _chunk_scratch(B, H, nc, K, r.device)
    if r.device.type == "meta":
        meta.charge("wkv6_bwd", 14 * K * r.numel(),
                    (r, k, v, w, u, dy, chunks, dstate),
                    (dr, dk, dv, dw, du_part, ds0))
        return dr, dk, dv, dw, du_part.sum((0, 2)), ds0
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().wkv6_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(), chunks.data_ptr(), _ptr(dstate),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), _ptr(ds0), after.data_ptr(),
            dsum.data_ptr(), F.data_ptr(), B, T, H, K, *_flags(r, w),
            stream)
    _check_launch("wkv6_bwd", err)
    LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du_part.sum((0, 2)), ds0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"no kernel for device {t.device}")


class Wkv6(torch.autograd.Function):
    """The recurrence with its gradient: the kernels on CUDA tensors (the
    step kernel or the chunked forward by ``uses_step``, keeping the chunk
    states when a gradient is wanted; the chunked backward), the plain
    versions (``ref``) on CPU tensors.  ``apply(r, k, v, w, u, state)`` ->
    (y (B, T, H, K) f32, final state (B, H, K, K) f32); each input's
    gradient comes back in its dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        need = any(ctx.needs_input_grad)
        cuda = r.device.type == "meta" or _on_cuda(r)
        u32 = u.to(torch.float32)
        s32 = None if state is None else state.to(torch.float32)
        if cuda:
            fwd = wkv6_step if uses_step(r.shape[1], s32) else wkv6_fwd
            out = fwd(r, k, v, w, u32, s32, chunks=need)
        else:
            out = ref.wkv6_ref(r, k, v, w, u32, s32)
        if not need:
            return out[0], out[1]
        chunks = out[2] if cuda else None
        ctx.save_for_backward(r, k, v, w, u32, s32, chunks)
        ctx.dtypes = (u.dtype, None if state is None else state.dtype)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u32, s32, chunks = ctx.saved_tensors
        dy = (torch.zeros(r.shape, dtype=torch.float32, device=r.device)
              if dy is None else dy.to(torch.float32).contiguous())
        if dstate is not None:
            dstate = dstate.to(torch.float32).contiguous()
        want_ds = ctx.needs_input_grad[5]
        if r.device.type == "meta" or _on_cuda(r):
            dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w, u32, dy, chunks,
                                               dstate, want_dstate=want_ds)
        else:
            dr, dk, dv, dw, du, ds0 = ref.wkv6_bwd_ref(r, k, v, w, u32, dy,
                                                       s32, dstate)
        u_dt, s_dt = ctx.dtypes
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dw.to(w.dtype), du.to(u_dt),
                ds0.to(s_dt) if want_ds else None)
