"""Wrappers of the CUDA flash-attention kernels, a forward and a backward
for each dtype; the forwards replace the Pallas TPU kernel of the JAX
package's ``kernels/flash_attention.py``:

* bf16 -> ``csrc/flash_attention_sm90.cu`` (``flash_attention_sm90``):
  wgmma and TMA on the tensor cores, computing the JAX model's bf16
  attention (``repro.models.attention.flash_attention``): q scaled by
  bf16(D^-1/2) and rounded to bf16, scores summed in f32, P rounded to
  bf16 for P V, l summed from the f32 p.  Plain version:
  ``ref.flash_attention_bf16_ref``.
* f32 -> ``csrc/flash_attention_f32_sm90.cu`` (``flash_attention_f32``):
  the Pallas kernel's f32 function on the tensor cores, each product as
  three TF32 products of hi / lo splits (3xTF32, f32 accuracy), wgmma and
  TMA as the bf16 kernel.  Plain version: ``ref.flash_attention_ref``.

The bf16 kernel rounds P against the running max of spans of the
caller's ``kv_tile`` keys (the JAX model's ``kv_chunk``, which every
caller passes): a multiple of its 128-key tile, or at least S for one
span.  Both forward kernels can also write the row statistic
lse = m + log(l), (B, H, T) f32, which the backward takes.

* the gradient, dq, dk, dv from q, k, v, o, lse and dO with
  FlashAttention-2's formula, deterministic (no atomics); plain version:
  ``ref.flash_attention_bwd_ref``.  Each dtype's kernel is a preprocess
  pass and dQ and dK / dV kernels on wgmma and TMA.  bf16 -> ``csrc/
  flash_attention_bwd_sm90.cu`` (``flash_attention_bwd_sm90``): dS kept
  in f32 as a bf16 hi + lo pair on the tensor cores; dK and dV sum each
  64-query tile's products in a fresh accumulator and add it to their
  running sums (over the query heads of their KV head and the query
  tiles) in IEEE f32 adds, since one running wgmma accumulator drifted
  past the bar at qwen3-32b's GQA heads.  f32 -> ``csrc/
  flash_attention_bwd_f32_sm90.cu`` (``flash_attention_bwd_f32_sm90``):
  Drow summed from its own P and dP (a pass before dQ's; the plain
  version's rowsum(dO o) put the forward's 3xTF32 error into dS where a
  row's attention is spread over nearly alike keys), 3xTF32 as the f32
  forward, its preprocess writing the operands split
  and the transposed ones (qs^T, dO^T, k^T) in ``TF32_KEY_ORDER``.  The
  JAX package has no Pallas counterpart: it differentiates its pure-JAX
  attention by autodiff.

q (B, T, H, D), k / v (B, S, HK, D), all contiguous on one CUDA device,
one dtype, D in {16, 32, 64, 112, 128}, H % HK == 0, causal or not, any
T and S (whisper's one-query decode step and its cross-attention of T
decoder tokens over S = 1500 frames among them).  Head dim 112
(zamba2-7b) runs D = 128 instances of the kernels compiled for a true
width of 112, on the tensors as they lie: the tensor maps keep the width
112, so TMA reads columns 112-127 as zeros, and the stores stop at 112
(the f32 backward's preprocess writes its scratch 128 wide).  ``window``
> 0 is the JAX model's sliding window
(``repro.models.attention.flash_attention(window=)``): key j is masked
for query i where j <= i - window, on top of the causal mask (a window
needs causal attention with T <= S, as the model calls it); 0 is none,
and runs instances compiled without the window's terms.  The kernels
skip the key tiles wholly outside every row's window; the bf16 forward
starts at the ``kv_tile`` span (aligned to key 0) that holds the first
live key, so its spans stay the JAX model's chunks.  The kernels mask the
ragged edges of T and S and index the KV head of each query head (GQA)
themselves, so nothing is padded or repeated (the backward kernels write
the scaled q once, into their scratch).  Each wrapper
checks its inputs, allocates the outputs, launches on the current
stream, raises if the launch failed, and adds one to its kernel's
``LAUNCHES`` entry.  ``FlashAttention`` is the autograd function over
them: the kernels for CUDA tensors, the plain versions for CPU tensors,
nothing in between; ``ops.flash_attention`` goes through it.  On meta
tensors (the dry run, ``launch.dryrun``) the wrappers check and allocate
as on the card and, in place of the launch, charge the kernel's cost to
``kernels.meta``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta, ref

HEAD_DIMS = (16, 32, 64, 112, 128)
# dtype -> (kernel name, C library, launch function)
KERNELS = {
    torch.bfloat16: ("flash_attention_sm90", "flash_attention_sm90",
                     "flash_attention_sm90_launch"),
    torch.float32: ("flash_attention_f32", "flash_attention_f32_sm90",
                    "flash_attention_launch"),
}
# both kernels run b * h along the grid's x dimension and the query tiles
# of 128 rows along y
_MAX_Q_TILES = 65535
_TILE = 128
# The f32 kernel's key order inside each 8-key step of P V: TF32 wgmma's
# A fragment takes columns (c, c + 4) where the accumulator holds (2c,
# 2c + 1), so A column i is key TF32_KEY_ORDER[i], and the kernel writes
# V^T's columns in the same order.
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# The f32 backward kernel's streamed tiles by head dim: (keys a step of its
# dQ kernel, queries a step of its dK / dV kernel), each a fresh wgmma
# accumulator added to the running sum.  The library reports its own
# (``flash_attention_bwd_f32_sm90_tile``), which chip_smoke.py holds
# against these; the CPU emulation of the kernel takes these.
F32_BWD_TILES = {16: (64, 64), 32: (64, 64), 64: (32, 32), 112: (32, 16),
                 128: (32, 16)}

# dtype -> the backward kernel's name, which is its C library's (csrc/
# <name>.cu, launch function ``<name>_launch`` and scratch size
# ``<name>_work_bytes``, one signature each for both)
BWD_KERNELS = {torch.bfloat16: "flash_attention_bwd_sm90",
               torch.float32: "flash_attention_bwd_f32_sm90"}
# the backwards' scratch pads T and S to this (csrc/flash_bwd_work.cuh)
_ROW_PAD = 128
# rows of the backward's smallest grid tile (the bf16 kernels' 128; the f32
# preprocess's 32), which bound T and S by the grid's 65535 tiles
_BWD_ROWS = {torch.bfloat16: 128, torch.float32: 32}

# launches since the last reset (a plain dict of ints)
LAUNCHES = {name: 0 for name, _, _ in KERNELS.values()}
LAUNCHES.update({name: 0 for name in BWD_KERNELS.values()})

_P = ctypes.c_void_p
_I = ctypes.c_int
_TYPED: set = set()


def _launcher(dtype: torch.dtype):
    _, lib_name, fn_name = KERNELS[dtype]
    fn = getattr(build.load(lib_name), fn_name)
    if id(fn) not in _TYPED:
        # q, k, v, o, lse, B, T, S, H, HK, D, causal, scale[, span],
        # window, stream
        span = [_I] if dtype == torch.bfloat16 else []
        fn.argtypes = ([_P] * 5 + [_I] * 7 + [ctypes.c_float] + span
                       + [_I, _P])
        fn.restype = ctypes.c_int
        _TYPED.add(id(fn))
    return fn


def _bwd_launcher(dtype: torch.dtype):
    name = BWD_KERNELS[dtype]
    fn = getattr(build.load(name), name + "_launch")
    if id(fn) not in _TYPED:
        # q, k, v, o, lse, dout, dq, dk, dv, scratch, B, T, S, H, HK, D,
        # causal, scale, window, stream
        fn.argtypes = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _P]
        fn.restype = ctypes.c_int
        _TYPED.add(id(fn))
    return fn


def bwd_work_bytes(dtype: torch.dtype, B: int, T: int, S: int, H: int,
                   HK: int, D: int) -> int:
    """The backward kernel's scratch bytes where no library is built (meta
    tensors): ``csrc/flash_bwd_work.cuh``'s formulas, which the libraries'
    ``<name>_work_bytes`` return and tests/test_torch_dryrun.py compiles
    to hold this to.  bf16: Drow and lse, (B, H, T_pad) f32 each, and the
    scaled q; f32: also the TF32 halves and the transposed operands, at
    head dim 128 for 112."""
    pad_t = -(-T // _ROW_PAD) * _ROW_PAD
    if dtype == torch.bfloat16:
        return 2 * B * H * pad_t * 4 + B * T * H * D * 2
    D = 128 if D == 112 else D
    pad_s = -(-S // _ROW_PAD) * _ROW_PAD
    rows = B * H * pad_t
    qn, qtn = 2 * B * T * H * D, 2 * B * H * D * pad_t
    kn, ktn = 2 * B * S * HK * D, 2 * B * HK * D * pad_s
    return 4 * (2 * rows + 2 * qn + 2 * qtn + 2 * kn + ktn)


def _bwd_scratch(q: torch.Tensor, B: int, T: int, S: int, H: int, HK: int,
                 D: int) -> torch.Tensor:
    """The backward kernel's scratch: the bytes its library's
    ``<name>_work_bytes`` asks for (``bwd_work_bytes`` on meta)."""
    if q.device.type == "meta":
        n = bwd_work_bytes(q.dtype, B, T, S, H, HK, D)
    else:
        name = BWD_KERNELS[q.dtype]
        fn = getattr(build.load(name), name + "_work_bytes")
        if id(fn) not in _TYPED:
            fn.argtypes = [_I] * 6
            fn.restype = ctypes.c_size_t
            _TYPED.add(id(fn))
        n = fn(B, T, S, H, HK, D)
    return torch.empty(n, dtype=torch.uint8, device=q.device)


def span_tiles(kv_tile: int, S: int) -> int:
    """The bf16 kernel's span in 128-key tiles for a ``kv_tile`` (the
    JAX model's ``kv_chunk``): a multiple of 128 is that many tiles (128
    is the single pass over each tile); anything at least S is one span
    over every key.  Other spans cannot be built from whole tiles and
    raise."""
    kv_tile = int(kv_tile)
    if kv_tile >= 1 and kv_tile % _TILE == 0:
        return kv_tile // _TILE
    if kv_tile >= S:
        return -(-S // _TILE)
    raise ValueError(
        f"kv_chunk {kv_tile}: the bf16 kernel rounds P against the running "
        f"max of spans of whole {_TILE}-key tiles, so the span must be a "
        f"multiple of {_TILE} or at least S = {S} (small chunks run only "
        f"on the CPU)")


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, T, S, H, HK, D) of a supported call, else raise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, T, H, D) q and "
                         "(B, S, HK, D) k, v")
    B, T, H, D = q.shape
    S, HK = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, S, HK, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if HK < 1 or H % HK:
        raise ValueError(f"{H} query heads are not a multiple of {HK} "
                         f"KV heads")
    if T < 1 or S < 1:
        raise ValueError(f"empty sequence: T={T}, S={S}")
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{list(KERNELS)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    return B, T, S, H, HK, D


def check_window(window, causal: bool, T: int, S: int) -> int:
    """The window as the kernels take it (0 for None), else raise: a
    window needs causal attention with T <= S, where every query has a key
    in its window (its own)."""
    window = 0 if window is None else int(window)
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if window and (not causal or T > S):
        raise ValueError(f"a window needs causal attention with T <= S, "
                         f"got causal={causal}, T={T}, S={S}")
    return window


def _check_cuda(q, named) -> None:
    """Every tensor on q's device, CUDA (or meta: the dry run), contiguous
    and, on CUDA, 16-byte aligned."""
    for name, t in named:
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"{name}: flash attention launches on CUDA, "
                             f"got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _scale(dtype: torch.dtype, D: int) -> float:
    """The forward's q scale: bf16(D^-1/2) for bf16, f32(D^-1/2) for
    f32 (a Python float, rounded to f32 by ctypes)."""
    return ref.bf16_scale(D) if dtype == torch.bfloat16 else D ** -0.5


def _check_launch(name: str, err: int) -> None:
    """Raise for a launcher's nonzero return: -1 (the driver has no tensor
    maps), -1000 - r (cuTensorMapEncodeTiled returned CUresult r), else a
    CUDA error."""
    if err == -1:
        raise RuntimeError(f"{name}: the CUDA driver has no "
                           f"cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {-1000 - err}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, kv_tile: int,
                    with_lse: bool = False, window: int = 0):
    """Launch q's dtype's kernel: the (B, T, H, D) attention output in q's
    dtype, and with ``with_lse`` also the (B, H, T) f32 row statistic
    lse = m + log(l).  ``kv_tile`` sets the bf16 kernel's span
    (``span_tiles``); the f32 kernel's result has no tiling.  ``window``:
    the sliding window (0 for none)."""
    B, T, S, H, HK, D = check_shapes(q, k, v)
    window = check_window(window, causal, T, S)
    _check_cuda(q, (("q", q), ("k", k), ("v", v)))
    name = KERNELS[q.dtype][0]
    if B * H >= 2 ** 31 or -(-T // _TILE) > _MAX_Q_TILES:
        raise ValueError(f"B * H = {B * H} or T = {T} exceeds the grid's "
                         f"limits")
    span = ([span_tiles(kv_tile, S)] if q.dtype == torch.bfloat16 else [])
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":  # the dry run: no launch, the cost charged
        meta.charge(name, 4 * B * H * D
                    * meta.attended_pairs(T, S, causal, window),
                    (q, k, v), (out, lse))
        return (out, lse) if with_lse else out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, T, S, H, HK, D,
            int(causal), _scale(q.dtype, D), *span, window, stream)
    _check_launch(name, err)
    LAUNCHES[name] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, o, lse, dout, causal: bool = True,
                        window: int = 0):
    """Launch q's dtype's backward kernel: (dq, dk, dv) in q's dtype,
    shaped as q, k, v, from the forward's inputs, output ``o``, row
    statistic ``lse`` (B, H, T) f32 and the output's gradient ``dout``;
    ``window`` the forward's (0 for none)."""
    B, T, S, H, HK, D = check_shapes(q, k, v)
    window = check_window(window, causal, T, S)
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
                    ("dout", dout)))
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (B, H, T), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
    name = BWD_KERNELS[q.dtype]
    rows = _BWD_ROWS[q.dtype]
    if (B * (H + HK) >= 2 ** 31
            or max(-(-T // rows), -(-S // rows)) > _MAX_Q_TILES):
        raise ValueError(f"B * (H + HK) = {B * (H + HK)}, T = {T} or S = "
                         f"{S} exceeds the grid's limits")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = _bwd_scratch(q, B, T, S, H, HK, D)
    if q.device.type == "meta":
        meta.charge(name, 2.5 * 4 * B * H * D
                    * meta.attended_pairs(T, S, causal, window),
                    (q, k, v, o, lse, dout), (dq, dk, dv))
        return dq, dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), B, T, S, H, HK, D,
            int(causal), _scale(q.dtype, D), window, stream)
    _check_launch(name, err)
    LAUNCHES[name] += 1
    return dq, dk, dv


def _plain_forward(q, k, v, causal, *, kv_tile, with_lse, window=0):
    if q.dtype == torch.bfloat16:
        return ref.flash_attention_bf16_ref(q, k, v, causal, kv_tile=kv_tile,
                                            return_lse=with_lse,
                                            window=window)
    return ref.flash_attention_ref(q, k, v, causal, return_lse=with_lse,
                                   window=window)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"no kernel for device {t.device}")


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: forward through q's dtype's kernel
    (writing lse when a gradient is wanted), backward through q's dtype's
    backward kernel (through ``flash_attention_bwd``), on a CUDA tensor;
    the plain versions (``ref``) on a CPU tensor.  Nothing falls back from
    one to the other.
    ``apply(q, k, v, causal, kv_tile, window)`` -> (B, T, H, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_tile, window=0):
        need = any(ctx.needs_input_grad[:3])
        run = (flash_attention if q.device.type == "meta" or _on_cuda(q)
               else _plain_forward)
        res = run(q, k, v, causal, kv_tile=kv_tile, with_lse=need,
                  window=window)
        if not need:
            return res
        out, lse = res
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        run = (flash_attention_bwd if q.device.type == "meta" or _on_cuda(q)
               else ref.flash_attention_bwd_ref)
        dq, dk, dv = run(q, k, v, o, lse, dout.contiguous(), ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None, None
