"""Message-level FL round protocol: the codec of the synchronous loop
(``repro_torch.fl.federated.FederatedAveraging``).

A round is identified by ``(seed, rnd)``; every party derives the round
key ``fold_in(PRNGKey(seed), rnd)`` locally, so the only bytes a client
uploads are its integer message:

  key              = fold_in(PRNGKey(seed), rnd)
  (kt, ks)         = split(key)           kt -> global (A, B) draw
  ck[p]            = split(ks, n)[p]      client p's dither key
  m_p              = mech.encode(clip(x_p), S(ck[p]), T(kt))   (ints)

The server decodes the *sum* of whatever subset of the announced cohort
reported (straggler renormalization: divide by the realized count r, not
the announced n).  The individual (layered) mechanisms are not
homomorphic: the server decodes each reported client's message with its
shared randomness, one client at a time, and averages the decoded values
over the realized count.  Keys and arithmetic follow the JAX package's
protocol, so the same ``(seed, rnd)`` gives the same payloads.

``ROUND_TIMES`` splits a round's wall time by phase when ``timing(True)``
is on: each phase then ends in a device synchronize, so it is off by
default.  With the sanitizer enabled (``repro_torch.debug``:
``REPRO_DEBUG_CHECKS=1`` or ``debug.checks()``) the encode and the
decode run under ``debug.checked``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import debug, resolve_device
from repro_torch.core import coding, dither, prng
from repro_torch.core.aggregate import AggregateGaussianMechanism
from repro_torch.core.distributions import Gaussian
from repro_torch.core.f32 import true_div
from repro_torch.core.irwin_hall import IrwinHallMechanism
from repro_torch.core.layered import LayeredQuantizer
from repro_torch.dist import compress as dcompress

__all__ = [
    "PROTOCOL_MECHANISMS",
    "RoundProtocol",
    "canonical_mechanism",
    "round_key",
    "client_dither_key",
    "expected_dither_keys",
    "ROUND_TIMES",
    "timing",
]

PROTOCOL_MECHANISMS = (
    "aggregate_gaussian",
    "aggregate_laplace",
    "irwin_hall",
    "individual_direct",
    "individual_shifted",
)

_ALIASES = {
    "layered_shifted": "individual_shifted",
    "layered_direct": "individual_direct",
    "none_": "none",
}

# seconds per phase ("ab_draw", "dither", "encode", "sum", "decode",
# "bits": the Elias-gamma count of unpacked messages)
ROUND_TIMES: Dict[str, float] = {}
_TIMING = [False]


@contextlib.contextmanager
def timing(enabled: bool = True):
    """Accumulate per-phase wall times into ROUND_TIMES (each phase ends
    in torch.cuda.synchronize when the card is in use)."""
    prev = _TIMING[0]
    _TIMING[0] = enabled
    try:
        yield ROUND_TIMES
    finally:
        _TIMING[0] = prev


@contextlib.contextmanager
def _phase(name: str, device: torch.device):
    if not _TIMING[0]:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ROUND_TIMES[name] = ROUND_TIMES.get(name, 0.0) + (
            time.perf_counter() - t0)


def canonical_mechanism(name: str) -> str:
    return _ALIASES.get(name, name)


def round_key(seed: int, rnd: int):
    """The shared per-round key every party derives locally."""
    return prng.fold_in(prng.PRNGKey(seed), rnd)


def client_dither_key(key, n: int, pos: int):
    """Client ``pos``'s dither key for a cohort of ``n``."""
    _, ks = prng.split(key)
    return prng.split(ks, n)[pos]


def expected_dither_keys(key, n: int) -> np.ndarray:
    """(n, 2) uint32 key data of every announced cohort position."""
    _, ks = prng.split(key)
    return prng.split(ks, n).numpy().astype(np.uint32)


# One process draws the shared (A, B) of a (key, n, d) once and reuses it
# for every party it plays (each client's encode and the server's
# decode).  Each party of the reference redraws it from the same key; the
# values are identical, so reusing them changes no result.  One entry is
# kept, and ``decode``, a round's last user, drops it.
_SHARED: Dict[tuple, tuple] = {}
# One encode or decode at a time in a process (the async runtime's client
# threads and its learner share one): the cache above is the process's,
# and threads that interleave the codec's many small tensor operations
# wait on the interpreter lock at each of them (4 threads at d = 48 on
# the CPU: 0.84 s interleaved, 0.19 s one after another).
_CODEC_LOCK = threading.RLock()


@dataclasses.dataclass(frozen=True)
class RoundProtocol:
    """Per-deployment codec parameters (the cohort size varies per round
    and is passed per call).

    mechanism: one of PROTOCOL_MECHANISMS (aliases accepted).
    sigma:     std of the *aggregated* error for the full cohort.
    clip:      per-coordinate clip before encoding.
    per_coord: one shared (A, B) per coordinate vs per tensor.
    msg_dtype: integer payload dtype on the unpacked wire.
    packed:    biased b-bit fields in int32 words (the fused codec).
    msg_bits:  packed field width (None: the msg_dtype default).
    device:    where the codec runs: CUDA unless "cpu" is asked for.
    """

    mechanism: str = "aggregate_gaussian"
    sigma: float = 1e-3
    clip: float = 1.0
    per_coord: bool = True
    msg_dtype: str = "int32"
    packed: bool = False
    msg_bits: Optional[int] = None
    device: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(
            self, "mechanism", canonical_mechanism(self.mechanism)
        )
        if self.mechanism not in PROTOCOL_MECHANISMS:
            raise KeyError(
                f"mechanism {self.mechanism!r} has no integer wire format; "
                f"protocol mechanisms: {PROTOCOL_MECHANISMS}"
            )
        if not self.sigma > 0.0:
            raise ValueError(f"sigma must be > 0, got {self.sigma}")
        if self.msg_dtype not in dcompress._MSG_DTYPES:
            raise KeyError(f"msg_dtype {self.msg_dtype!r} not in "
                           f"{dcompress._MSG_DTYPES}")
        if self.packed and self.mechanism not in dcompress.HOMOMORPHIC:
            raise ValueError(
                f"packed uplink needs an integer-homomorphic mechanism "
                f"({dcompress.HOMOMORPHIC}), got {self.mechanism!r}")
        object.__setattr__(self, "device", str(resolve_device(self.device)))

    @property
    def _dev(self) -> torch.device:
        return torch.device(self.device)

    def _comp(self) -> dcompress.CompressionConfig:
        """The equivalent compress config: the packed wire format is the
        fused codec."""
        return dcompress.CompressionConfig(
            mechanism=self.mechanism, sigma=self.sigma, clip=self.clip,
            msg_dtype=self.msg_dtype, per_coord=self.per_coord,
            fused=True, msg_bits=self.msg_bits,
        )

    def payload_size(self, n: int, d: int) -> int:
        """Elements of one client's wire payload for a ``d``-dim update
        (packed: int32 words incl. row padding; else one word/coord)."""
        if not self.packed:
            return d
        geom = dcompress.leaf_geometry(self._comp(), n)
        lanes = 128 * max(32 // geom.bits, 1)
        return -(-d // lanes) * 128  # padded rows of 128 words

    def _shared(self, kt, n: int, d: int) -> tuple:
        """The round's shared (step, offset, geometry), drawn once."""
        tag = (self, tuple(kt.tolist()), n, d)
        hit = _SHARED.get(tag)
        if hit is None:
            _SHARED.clear()
            with _phase("ab_draw", self._dev):
                if self.packed:
                    hit = dcompress._leaf_params(self._comp(), n, kt, (d,),
                                                 self._dev)
                elif self.mechanism == "irwin_hall":
                    hit = (IrwinHallMechanism(n, self.sigma).w, None, None)
                else:
                    mech = self._agg_mech(n)
                    t = mech.global_randomness(
                        kt, (d,), a_min=mech.a_min_for_range(2.0 * self.clip),
                        device=self._dev)
                    hit = (t.A * mech.w, t.B * self.sigma, None)
            _SHARED[tag] = hit
        return hit

    def _layered_q(self, n: int) -> LayeredQuantizer:
        """Per-client noise N(0, n sigma^2) averages to N(0, sigma^2)."""
        return LayeredQuantizer(
            Gaussian(self.sigma * math.sqrt(n)),
            shifted=self.mechanism == "individual_shifted")

    def _agg_mech(self, n: int) -> AggregateGaussianMechanism:
        family = ("laplace" if self.mechanism == "aggregate_laplace"
                  else "gaussian")
        return AggregateGaussianMechanism(n, self.sigma, self.per_coord,
                                          family=family)

    # ----------------------------------------------------------- encode
    def client_message(self, key, n: int, pos: int, x) -> torch.Tensor:
        """Encode client ``pos``'s (unclipped) flat update for a cohort of
        ``n``.  Returns the integer wire payload on the protocol's device:
        one ``msg_dtype`` word per coordinate, or (packed) biased b-bit
        fields in int32 words, which ADD homomorphically across clients."""
        encode = self._client_message
        if debug.sanitize_enabled():
            encode = debug.checked(encode)
        with _CODEC_LOCK:
            return encode(key, n, pos, x)

    def _client_message(self, key, n: int, pos: int, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self._dev, dtype=torch.float32)
        x = torch.clamp(x.reshape(-1), -self.clip, self.clip)
        d = x.numel()
        kt, ks = prng.split(key)
        ck = prng.split(ks, n)[pos]
        if self.mechanism not in dcompress.HOMOMORPHIC:
            q = self._layered_q(n)
            with _phase("dither", self._dev):
                rand = q.randomness(ck, (d,), device=self._dev)
            with _phase("encode", self._dev):
                m = q.encode(x, rand)
                return m.to(dcompress._MSG_DTYPES[self.msg_dtype])
        step, _, geom = self._shared(kt, n, d)
        with _phase("dither", self._dev):
            s_i = dither.dither_noise(ck, (d,), device=self._dev)
        with _phase("encode", self._dev):
            if self.packed:
                return dcompress.encode_leaf(x, self._comp(), step, s_i,
                                             geom).reshape(-1)
            m = dither.dither_encode(x, step, s_i)
            return m.to(dcompress._MSG_DTYPES[self.msg_dtype])

    # ----------------------------------------------------------- decode
    def decode(self, key, n: int, msgs: torch.Tensor, mask,
               d: Optional[int] = None) -> Tuple[torch.Tensor, float]:
        """Decode a round from the realized subset of the cohort.

        msgs: (n, p) integer payloads (p = d unpacked, or the packed word
              count); rows where mask is False are ignored.
        mask: (n,) bool — which announced positions reported.
        d:    update dimension; required when packed.
        Returns ``(y, bits_per_coord)``: the straggler-renormalized mean
        update and the wire bits per coordinate (measured Elias-gamma for
        unpacked payloads; the exact packed width otherwise).
        """
        decode = self._decode
        if debug.sanitize_enabled():
            decode = debug.checked(decode)
        with _CODEC_LOCK:
            return decode(key, n, msgs, mask, d)

    def _decode(self, key, n: int, msgs, mask,
                d: Optional[int]) -> Tuple[torch.Tensor, float]:
        if d is None:
            if self.packed:
                raise ValueError("packed decode needs the update dim d")
            d = msgs.shape[-1]
        d = int(d)
        dev = self._dev
        mask = np.asarray(torch.as_tensor(mask).cpu(), bool).reshape(-1)
        # the realized count, as the reference's traced f32
        r = np.float32(max(float(mask.sum()), 1.0))
        msgs = torch.as_tensor(msgs).to(dev)
        kt, ks = prng.split(key)
        cks = prng.split(ks, n)
        if self.mechanism not in dcompress.HOMOMORPHIC:
            return self._decode_individual(cks, n, msgs, mask, r, d)
        step, offset, geom = self._shared(kt, n, d)
        _SHARED.clear()  # the round's draw dies with this decode

        with _phase("dither", dev):
            s_sum = torch.zeros(d, dtype=torch.float32, device=dev)
            s_j = torch.empty(d, dtype=torch.float32, device=dev)
            for j in range(n):
                # repro-lint: disable=rng-key-reuse -- cks[j] is client
                # j's own key: one draw per cohort position
                dither.dither_noise(cks[j], (d,), out=s_j)
                s_sum += s_j * float(mask[j])
        with _phase("sum", dev):
            live = torch.as_tensor(mask, device=dev)
            msgs = torch.where(live[:, None], msgs.to(torch.int32), 0)
            m_sum = msgs.sum(0, dtype=torch.int32)

        with _phase("decode", dev):
            if self.packed:
                # the masked word sum IS the homomorphic aggregate; decode
                # with the ANNOUNCED-n step/geometry but the REALIZED-r
                # divisor and bias count
                y = dcompress.decode_leaf_sum(
                    m_sum.reshape(-1, 128), self._comp(), r, r, step,
                    offset, s_sum, geom, (d,))
                return y, float(np.float32(32.0 * msgs.shape[-1] / d))
            bits_pc = self._bits_per_coord(msgs, mask, r, d)
            # announced-n step, realized-r divisor (r == n recovers the
            # exact-error decode)
            y = (m_sum.to(torch.float32) - s_sum) * \
                dcompress._step_dec(step, r)
            return (y if offset is None else y + offset), bits_pc

    def _bits_per_coord(self, msgs, mask, r, d: int) -> float:
        """Measured Elias-gamma bits per coordinate of the reported
        messages: the reference's sum / (r * d), with the sum exact."""
        with _phase("bits", self._dev):
            total = sum(coding.elias_gamma_total(msgs[j])
                        for j in range(msgs.shape[0]) if mask[j])
        return float(np.float32(total) / (r * np.float32(d)))

    def _decode_individual(self, cks, n: int, msgs, mask, r,
                           d: int) -> Tuple[torch.Tensor, float]:
        """Decode each reported client's message with its (U, layer) and
        average over the realized count, one client at a time: the
        reference's vmap over the cohort holds n (U, layer) pairs, 2 n d
        floats, where this holds one."""
        dev = self._dev
        q = self._layered_q(n)
        msgs = msgs.to(torch.int32)  # as the reference, before any sum
        y = torch.zeros(d, dtype=torch.float32, device=dev)
        for j in range(n):
            if not mask[j]:
                continue  # the reference adds its decode times 0
            with _phase("dither", dev):
                rand = q.randomness(cks[j], (d,), device=dev)
            with _phase("decode", dev):
                y += q.decode(msgs[j], rand)
            del rand
        with _phase("decode", dev):
            y = true_div(y, float(r))
        return y, self._bits_per_coord(msgs, mask, r, d)
