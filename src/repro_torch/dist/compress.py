"""Compressed aggregation codec of the homomorphic mechanisms.

Every client clips and encodes its update into integer messages, the
messages are summed as integers, and the *sum* is decoded, so the
aggregated error follows the mechanism's law exactly:

  aggregate_gaussian — N(0, sigma^2) exactly (paper Prop. 3)
  aggregate_laplace  — Laplace(0, sigma/sqrt(2)) exactly
  irwin_hall         — IH(n, 0, sigma^2) exactly (Sec. 4.2)
  layered_shifted    — per-client N(0, n sigma^2) decoded locally
                       (Def. 5; not homomorphic)
  layered_direct     — as above with the direct layering (Def. 4)
  none_              — clip only (no quantization)

Shared randomness comes from one per-round key: the global (A, B) draw
uses it directly, client i's dither uses ``fold_in(key, i)``, and the
decode recomputes the dither from the same key, so only integers cross
between parties.

``compress_tree(axis=group)`` runs across client ranks: ``group`` is a
``torch.distributed`` process group of the ``n_clients`` clients (the JAX
package's mesh axis), each rank holding its own client's update.  Every
rank encodes with its group rank as the client index, an int32
``all_reduce(SUM)`` sums the messages (the JAX package's integer
``psum``), and every rank decodes the sum, recomputing the other
clients' dithers from the shared key; the layered mechanisms and
``none_`` average floats with an ``all_reduce(SUM)`` and a division (its
``pmean``).  Both go through ``dist.collectives`` (a group there may be
the dry run's ``RecordingGroup``).  The result is the same on every
rank.  The group's backend is the caller's choice (gloo on the CPU; on
one card the ranks share a device, which NCCL refuses, so gloo carries
the CUDA tensors there too).

Two wire formats:

  * unfused (default): one signed ``msg_dtype`` word per coordinate;
  * fused (``CompressionConfig(fused=True)``): dither + quantize + bias +
    bit-pack run in one kernel pass per direction (``kernels.ops``: the
    CUDA kernels on the card, their plain versions on the CPU), and the
    sum carries b-bit fields packed into int32 words.  Both clamp to the
    same ``PackGeometry``, so they encode identical messages.

The sanitizer's checks (``repro_torch.debug``) sit where the JAX
package has them; they run only under ``debug.checked``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import debug, resolve_device
from repro_torch.core import coding, dither, prng
from repro_torch.core.aggregate import AggregateGaussianMechanism
from repro_torch.core.distributions import Gaussian
from repro_torch.core.f32 import rcp_mul, true_div
from repro_torch.core.irwin_hall import IrwinHallMechanism
from repro_torch.core.layered import LayeredQuantizer
from repro_torch.core.packing import PackGeometry, geometry_for_range
from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops

PyTree = Any

MECHANISMS = (
    "none_",
    "aggregate_gaussian",
    "aggregate_laplace",
    "irwin_hall",
    "layered_shifted",
    "layered_direct",
)

HOMOMORPHIC = ("aggregate_gaussian", "aggregate_laplace", "irwin_hall")

_MSG_DTYPES = {"int32": torch.int32, "int16": torch.int16, "int8": torch.int8}

# default packed field width per payload dtype: the widest field whose
# biased sums fit the dtype's signed range unfused and stay f32-exact
# (<= 2^24) in the fused decode
_DEFAULT_PACK_BITS = {"int32": 24, "int16": 15, "int8": 7}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Cross-client compression.

    mechanism: one of MECHANISMS.
    sigma:     std of the *aggregated* error.
    clip:      per-coordinate clip applied before encoding.
    msg_dtype: integer payload ("int32"/"int16"/"int8") of the unfused path.
    per_coord: one (A, B) shared draw per coordinate vs one per tensor.
    fused:     run through the fused encode/decode kernels with packed
               b-bit payloads.
    msg_bits:  packed field width b for the aggregate mechanisms (their
               step scale A is clamped so messages fit); for irwin_hall an
               upper bound on the derived natural width.  None picks the
               ``msg_dtype`` default.
    """

    mechanism: str = "aggregate_gaussian"
    sigma: float = 1e-4
    clip: float = 1.0
    msg_dtype: str = "int32"
    per_coord: bool = True
    fused: bool = False
    msg_bits: Optional[int] = None

    def __post_init__(self):
        if self.mechanism not in MECHANISMS:
            raise KeyError(
                f"unknown mechanism {self.mechanism!r}; have {MECHANISMS}"
            )
        if self.mechanism != "none_" and not self.sigma > 0.0:
            raise ValueError(f"sigma must be > 0, got {self.sigma}")
        if self.msg_dtype not in _MSG_DTYPES:
            raise KeyError(f"msg_dtype {self.msg_dtype!r} not in {_MSG_DTYPES}")
        if self.fused and self.mechanism not in HOMOMORPHIC:
            raise ValueError(
                f"fused packing needs an integer-homomorphic mechanism "
                f"({HOMOMORPHIC}), got {self.mechanism!r}"
            )
        if self.msg_bits is not None and not 2 <= self.msg_bits <= 24:
            raise ValueError(
                f"msg_bits must be in [2, 24], got {self.msg_bits}"
            )


def _make_mech(comp: CompressionConfig, n: int):
    if comp.mechanism in ("aggregate_gaussian", "aggregate_laplace"):
        return AggregateGaussianMechanism(
            n, comp.sigma, comp.per_coord,
            family=comp.mechanism.removeprefix("aggregate_"),
        )
    return IrwinHallMechanism(n, comp.sigma)


def leaf_geometry(comp: CompressionConfig, n: int) -> Optional[PackGeometry]:
    """Packed-field geometry of one homomorphic leaf, or None when the
    config runs the unclamped int32 path (not fused, no msg_bits)."""
    if comp.mechanism not in HOMOMORPHIC:
        return None
    if not comp.fused and comp.msg_bits is None:
        return None
    n = max(int(n), 1)
    bits = (comp.msg_bits if comp.msg_bits is not None
            else _DEFAULT_PACK_BITS[comp.msg_dtype])
    mech = _make_mech(comp, n)
    if isinstance(mech, IrwinHallMechanism):
        # natural range, capped at the configured width
        m_nat = math.ceil(comp.clip / mech.w) + 1
        m_cap = ((1 << bits) - 1) // (2 * n)
        return geometry_for_range(min(m_nat, max(m_cap, 2)), n)
    return mech.pack_geometry(bits)


def _leaf_params(comp: CompressionConfig, n: int, kt, shape, device) -> Tuple[
        Any, Optional[torch.Tensor], Optional[PackGeometry]]:
    """(step, offset, geometry) of a homomorphic leaf: step is the dither
    step (scalar w, or the shared per-coordinate A*w tensor), offset the
    shared additive term (B*sigma, or None)."""
    mech = _make_mech(comp, n)
    geom = leaf_geometry(comp, n)
    if isinstance(mech, AggregateGaussianMechanism):
        a_min = (mech.a_min_for_geometry(comp.clip, geom)
                 if geom is not None
                 else mech.a_min_for_range(2.0 * comp.clip))
        t = mech.global_randomness(kt, shape, a_min=a_min, device=device)
        return t.A * mech.w, t.B * comp.sigma, geom
    return mech.w, None, geom


def encode_leaf(x32, comp: CompressionConfig, step, s_i,
                geom: Optional[PackGeometry]) -> torch.Tensor:
    """One client's integer message for a clipped f32 leaf: biased packed
    int32 words (R, 128) when fused, else the signed per-coordinate
    message (clamped to the shared geometry when one is active)."""
    if debug.active():
        debug.check(torch.all(torch.isfinite(x32)),
                    "encode: non-finite input leaf")
        if geom is not None and comp.mechanism != "irwin_hall":
            # aggregate mechanisms size a_min so the natural (pre-clamp)
            # message fits the b-bit field; a violation means the A clamp
            # upstream is wrong and the clamped message silently biases
            # the decoded mean (irwin_hall's cap clamps by design).  The
            # message stays f32: past int32's range the cast would wrap
            m_raw = dither.dither_encode(x32, step, s_i,
                                         msg_dtype=torch.float32)
            debug.check(
                torch.all(torch.abs(m_raw) <= geom.m_max),
                "encode: message overflows the b-bit field "
                "(|m| > m_max={m_max})", m_max=geom.m_max)
    if comp.fused:
        return ops.fused_pack_encode(x32, s_i, step, geom.bits, geom.m_max)
    m = dither.dither_encode(x32, step, s_i)
    if geom is not None:
        m = torch.clamp(m, -geom.m_max, geom.m_max)
    return m


def _step_dec(step, n):
    """step / n.  ``n`` is a python int (the cohort size, a constant in the
    reference: a scalar step is divided in f64, a tensor one by XLA's f32
    reciprocal) or a numpy float32 (the realized count, traced in the
    reference: divided in f32)."""
    if isinstance(step, torch.Tensor):
        if isinstance(n, np.floating):
            return true_div(step, float(n))
        return rcp_mul(step, n)
    if isinstance(n, np.floating):
        return float(np.float32(step) / np.float32(n))
    return step / n


def decode_leaf_sum(m_sum, comp: CompressionConfig, n, r_msgs,
                    step, offset, s_sum, geom: Optional[PackGeometry],
                    shape) -> torch.Tensor:
    """Decode the SUM of ``r_msgs`` messages into the across-clients mean
    + exact noise.  ``n`` is the decode divisor (the cohort size, or the
    realized count for straggler renormalization, see ``_step_dec``);
    ``r_msgs`` the number of messages summed (their biases are removed)."""
    step_dec = _step_dec(step, n)
    if comp.fused:
        if debug.active():
            # each packed field carries sum_i (m_i + bias) over the r_msgs
            # summed messages; anything above r_msgs * 2 * m_max is an
            # overflowed or tampered lane that the bias-stripping decode
            # would silently turn into a wrong mean
            words = m_sum.to(torch.int64) & 0xFFFFFFFF
            fmask = (1 << geom.bits) - 1
            fields = torch.stack([(words >> (geom.bits * j)) & fmask
                                  for j in range(geom.group)])
            debug.check(
                torch.all(fields <= float(r_msgs) * 2 * geom.m_max),
                "decode: packed field sum exceeds r * 2 * m_max "
                "(overflowed or tampered lane)")
        bias = float(np.float32(r_msgs) * np.float32(geom.bias))
        s_eff = s_sum + bias
        y = ops.fused_unpack_decode(m_sum, s_eff, step_dec, offset,
                                    geom.bits, shape)
        if debug.active():
            debug.check(torch.all(torch.isfinite(y)),
                        "decode: non-finite output (fused path)")
        return y
    if debug.active() and geom is not None:
        debug.check(
            torch.all(torch.abs(m_sum) <= float(r_msgs) * geom.m_max),
            "decode: summed message exceeds r * m_max for the declared "
            "geometry")
    y = (m_sum.to(torch.float32) - s_sum) * step_dec
    if debug.active():
        debug.check(torch.all(torch.isfinite(y)),
                    "decode: non-finite output")
    return y if offset is None else y + offset


def _layered_q(comp: CompressionConfig, n: int) -> LayeredQuantizer:
    """Per-client noise N(0, n sigma^2) averages to N(0, sigma^2)."""
    return LayeredQuantizer(Gaussian(comp.sigma * math.sqrt(n)),
                            shifted=comp.mechanism == "layered_shifted")


def _client_index(group) -> int:
    return coll.rank(group)


def _dither_sum(ks, n: int, shape, device) -> torch.Tensor:
    """sum_j S_j, j < n, recomputed from the shared key (every rank holds
    the round key, so no float crosses ranks for the dither sum), added
    in the order of the JAX package's compiled reduce: j = 0, 1, ...,
    one f32 add each."""
    total = torch.zeros(shape, dtype=torch.float32, device=device)
    s_j = torch.empty_like(total)
    for j in range(n):  # client j's own dither key
        total += dither.dither_noise(prng.fold_in(ks, j), shape, out=s_j)
    return total


def _psum_msg(m, comp: CompressionConfig, group) -> torch.Tensor:
    """The summed messages as int32.  Unfused messages are narrowed to
    ``msg_dtype`` first and the sum narrowed again: that wraps exactly
    as the JAX package's narrow ``psum`` does (a sum modulo 2^k), while
    the collective itself adds int32, which every backend reduces."""
    if not comp.fused:
        m = m.to(_MSG_DTYPES[comp.msg_dtype]).to(torch.int32)
    if group is None:
        return m
    m = coll.all_reduce(m, group)
    if not comp.fused:
        m = m.to(_MSG_DTYPES[comp.msg_dtype]).to(torch.int32)
    return m


def _pmean(y, group, n: int) -> torch.Tensor:
    """The JAX package's ``pmean``: a float sum across ranks, divided by
    the group's size, a constant, which XLA compiles as a multiply by its
    f32 reciprocal."""
    return rcp_mul(coll.all_reduce(y, group), n)


def _compress_leaf(x, comp: CompressionConfig, key, n: int, device,
                   group=None):
    dtype = x.dtype
    x32 = torch.clamp(x.to(device=device, dtype=torch.float32),
                      -comp.clip, comp.clip)
    shape = tuple(x32.shape)
    if comp.mechanism == "none_":
        y = x32 if group is None else _pmean(x32, group, n)
        return y.to(dtype)
    kt, ks = prng.split(key)
    idx = _client_index(group)
    if comp.mechanism not in HOMOMORPHIC:
        # point-to-point AINQ per client, decoded locally; across ranks
        # the decodes are averaged
        q = _layered_q(comp, n)
        rand = q.randomness(prng.fold_in(ks, idx), shape, device=device)
        y = q.decode(q.encode(x32, rand), rand)
        del rand, x32
        return (y if group is None else _pmean(y, group, n)).to(dtype)
    step, offset, geom = _leaf_params(comp, n, kt, shape, device)
    s_i = dither.dither_noise(prng.fold_in(ks, idx), shape, device=device)
    m_sum = _psum_msg(encode_leaf(x32, comp, step, s_i, geom), comp, group)
    del x32
    if group is None:
        s_sum, r_msgs = s_i, 1
    else:
        del s_i
        s_sum, r_msgs = _dither_sum(ks, n, shape, device), n
    y = decode_leaf_sum(m_sum, comp, n, r_msgs, step, offset, s_sum, geom,
                        shape)
    return y.to(dtype)


def _flatten(tree):
    """Leaves in the reference's pytree order (dict keys sorted) and a
    function rebuilding the structure from new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"unsupported tree node {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, off = [], 0
        for (_, fn), k in zip(parts, sizes):
            out.append(fn(new[off:off + k]))
            off += k
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def compress_tree(grads: PyTree, comp: CompressionConfig, key,
                  axis=None, n_clients: int = 1, device=None) -> PyTree:
    """Compress-aggregate a tree of tensors across ``axis``.

    ``axis`` is a ``torch.distributed`` process group of ``n_clients``
    client ranks, each calling with its own client's tree: the return
    value is the across-clients mean plus the mechanism's exact noise,
    the same on every rank.  With ``axis=None`` (n_clients=1) this is the
    point-to-point mechanism: quantize + exact noise, no collective.
    Runs on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    n = max(int(n_clients), 1)
    if axis is not None and not coll.is_group(axis):
        raise TypeError(
            f"axis must be a torch.distributed ProcessGroup of the client "
            f"ranks (the JAX package's mesh axis name has no counterpart), "
            f"got {axis!r}")
    if axis is not None and coll.size(axis) != n:
        raise ValueError(
            f"n_clients={n} but the process group has "
            f"{coll.size(axis)} ranks")
    leaves, rebuild = _flatten(grads)
    return rebuild([
        _compress_leaf(g, comp, prng.fold_in(key, i), n, device, axis)
        for i, g in enumerate(leaves)
    ])


# --------------------------------------------------------- bit accounting
def message_bits(comp: CompressionConfig, n_clients: int, *,
                 num_samples: int = 8192, device=None) -> float:
    """Per-coordinate message size (bits) one client sends per round for
    inputs clipped to [-clip, clip]: the fixed-length mechanisms' exact
    code size (irwin_hall, layered_shifted), or the variable-length ones'
    expected Elias-gamma length (aggregate_*, layered_direct) over a
    deterministic draw of the shared randomness and uniform inputs."""
    n = max(int(n_clients), 1)
    t = 2.0 * comp.clip
    if comp.mechanism == "none_":
        return 32.0
    if comp.mechanism == "irwin_hall":
        return float(IrwinHallMechanism(n, comp.sigma).bits_fixed(t))
    if comp.mechanism == "layered_shifted":
        return float(_layered_q(comp, n).fixed_bits(t))
    device = resolve_device(device)
    kx, kr = prng.split(prng.PRNGKey(0))
    x = prng.uniform(kx, (num_samples,), -comp.clip, comp.clip, device=device)
    if comp.mechanism == "layered_direct":
        q = _layered_q(comp, n)
        m = q.encode(x, q.randomness(kr, x.shape, device=device))
    else:
        mech = _make_mech(comp, n)
        tshared = mech.global_randomness(prng.fold_in(kr, 0), x.shape,
                                         device=device)
        s = mech.client_randomness(prng.fold_in(kr, 1), x.shape,
                                   device=device)
        m = mech.encode(x, s, tshared)
    return coding.mean_of_total(coding.elias_gamma_total(m), m.numel())


def wire_bits_per_coord(comp: CompressionConfig, n_clients: int,
                        size: Optional[int] = None) -> float:
    """Bits per coordinate a client's payload occupies on the wire:
    ``32 / group`` for the fused packed format (exact, including word
    padding, when ``size`` is given), else the ``msg_dtype`` width."""
    geom = leaf_geometry(comp, max(int(n_clients), 1))
    if comp.fused and geom is not None:
        if size:
            return 32.0 * geom.n_words(size) / size
        return 32.0 / geom.group
    return float(torch.iinfo(_MSG_DTYPES[comp.msg_dtype]).bits)
