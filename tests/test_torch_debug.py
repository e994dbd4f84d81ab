"""The port's sanitizer (``repro_torch.debug``) against the cases of the
JAX package's own sanitizer tests (tests/test_packing.py): the clean
path keeps every bit, and each injected fault that the plain decode
would turn silently into a wrong mean raises ``SanitizeError`` under
``debug.checks()``, with the reference's messages.  Inputs are made with
numpy from a seed."""
import numpy as np
import pytest
import torch

from repro import debug as jdebug
from repro.runtime import protocol as jproto
from repro_torch import debug
from repro_torch.core.aggregate import AggregateGaussianMechanism
from repro_torch.core import prng
from repro_torch.dist import compress as dcompress
from repro_torch.runtime import protocol


def _packed_proto():
    return protocol.RoundProtocol(mechanism="irwin_hall", sigma=1e-3,
                                  packed=True, msg_bits=8, device="cpu")


def _messages(proto, key, n, d, scale=0.1):
    rng = np.random.default_rng(0)
    x = [rng.standard_normal(d).astype(np.float32) * scale
         for _ in range(n)]
    return torch.stack([proto.client_message(key, n, p, x[p])
                        for p in range(n)])


def _tamper(msgs, geom, rows):
    """A copy of ``msgs`` whose summed lane 0 of one word reaches
    2^b - 1 over ``rows``, with no carry into the next lane."""
    field_mask = (1 << geom.bits) - 1
    w = next(w for w in range(msgs.shape[1])
             if sum(int(msgs[r, w]) & field_mask for r in rows)
             < field_mask)
    lane_sum = sum(int(msgs[r, w]) & field_mask for r in rows)
    tampered = msgs.copy()
    tampered[rows[0], w] += field_mask - lane_sum
    return tampered


def test_names_match_the_reference():
    for name in jdebug.__all__:
        assert hasattr(debug, name), name
    assert debug.ENV_VAR == jdebug.ENV_VAR
    assert debug.A_CLAMP_MASS_BOUND == jdebug.A_CLAMP_MASS_BOUND


def test_sanitizer_clean_path_bit_identical():
    """Enabling the sanitizer changes no bit of the codec's output."""
    proto, n, d = _packed_proto(), 3, 256
    key = protocol.round_key(7, 0)
    msgs = _messages(proto, key, n, d)
    y0, b0 = proto.decode(key, n, msgs, np.ones(n, bool), d=d)
    with debug.checks():
        assert debug.sanitize_enabled()
        msgs1 = _messages(proto, key, n, d)
        y1, b1 = proto.decode(key, n, msgs1, np.ones(n, bool), d=d)
    assert torch.equal(msgs, msgs1)
    assert torch.equal(y0, y1)
    assert b0 == b1


def test_sanitizer_catches_injected_field_overflow():
    """Realized r = 2 of an announced n = 3: one packed lane pushed past
    r * 2 * m_max decodes silently (and wrongly) without the sanitizer,
    and raises under it."""
    proto, n, d = _packed_proto(), 3, 256
    key = protocol.round_key(7, 0)
    geom = dcompress.leaf_geometry(proto._comp(), n)
    assert 2 * 2 * geom.m_max < (1 << geom.bits) - 1
    msgs = _messages(proto, key, n, d).numpy()
    mask = np.array([True, True, False])
    tampered = _tamper(msgs, geom, (0, 1))
    y_clean, _ = proto.decode(key, n, torch.from_numpy(msgs), mask, d=d)
    y_bad, _ = proto.decode(key, n, torch.from_numpy(tampered), mask, d=d)
    assert float((y_bad - y_clean).abs().max()) > 0.0
    with debug.checks():
        with pytest.raises(debug.SanitizeError,
                           match="packed field sum exceeds"):
            proto.decode(key, n, torch.from_numpy(tampered), mask, d=d)


def test_sanitizer_catches_encode_overflow():
    """A mis-sized step overflows the pre-clamp message; the encode-side
    check refuses to let the clamp bias the mean silently."""
    comp = dcompress.CompressionConfig(mechanism="aggregate_gaussian",
                                       sigma=1e-3, fused=True)
    geom = dcompress.leaf_geometry(comp, 3)
    bad_encode = debug.checked(
        lambda x, s: dcompress.encode_leaf(
            x, comp, torch.tensor(1e-12), s, geom))
    with pytest.raises(debug.SanitizeError,
                       match=f"overflows the b-bit field .*{geom.m_max}"):
        bad_encode(torch.full((128,), 0.5), torch.zeros(128))


def test_sanitizer_catches_non_finite_input():
    comp = dcompress.CompressionConfig(mechanism="irwin_hall", sigma=1e-3,
                                       fused=True)
    geom = dcompress.leaf_geometry(comp, 2)
    x = torch.zeros(256)
    x[3] = float("nan")
    encode = debug.checked(dcompress.encode_leaf)
    with pytest.raises(debug.SanitizeError, match="non-finite input"):
        encode(x, comp, 0.01, torch.zeros(256), geom)


def test_sanitizer_bounds_a_clamp_mass():
    """An absurd a_min clamps nearly every A draw; the total-variation
    bound on the clamp mass rejects the geometry."""
    mech = AggregateGaussianMechanism(3, 1e-3)
    key = prng.PRNGKey(0)
    ok = debug.checked(lambda k: mech.global_randomness(
        k, (512,), a_min=1e-6, device="cpu"))
    bad = debug.checked(lambda k: mech.global_randomness(
        k, (512,), a_min=100.0, device="cpu"))
    ok(key)
    with pytest.raises(debug.SanitizeError, match="A-clamp mass"):
        bad(key)
    bad.__wrapped__(key)  # outside `checked`: no check


def test_sanitizer_env_and_override(monkeypatch):
    monkeypatch.delenv(debug.ENV_VAR, raising=False)
    assert not debug.sanitize_enabled()
    monkeypatch.setenv(debug.ENV_VAR, "1")
    assert debug.sanitize_enabled()
    with debug.checks(False):
        assert not debug.sanitize_enabled()
    monkeypatch.setenv(debug.ENV_VAR, "0")
    assert not debug.sanitize_enabled()
    # outside `checked`, debug.check is a no-op even when enabled
    debug.check(False, "never raised")


def test_inactive_check_reads_no_predicate():
    """Outside ``checked`` a check never reads its predicate (no host
    sync), and ``active()`` is false, so the call sites build none."""

    class Unread:
        def __bool__(self):
            raise AssertionError("predicate read")

    assert not debug.active()
    debug.check(Unread(), "never read")
    with pytest.raises(AssertionError, match="predicate read"):
        debug.checked(lambda: debug.check(Unread(), "read"))()


def test_protocol_runs_checked_when_enabled(monkeypatch):
    """With the environment variable set, the protocol's decode runs
    under ``checked``: the tampered lane raises without ``checks()``."""
    proto, n, d = _packed_proto(), 2, 128
    key = protocol.round_key(3, 1)
    geom = dcompress.leaf_geometry(proto._comp(), n)
    msgs = torch.from_numpy(_tamper(_messages(proto, key, n, d).numpy(),
                                    geom, (0, 1)))
    proto.decode(key, n, msgs, np.ones(n, bool), d=d)
    monkeypatch.setenv(debug.ENV_VAR, "1")
    with pytest.raises(debug.SanitizeError, match="packed field"):
        proto.decode(key, n, msgs, np.ones(n, bool), d=d)


def test_both_packages_refuse_the_same_tampered_payload():
    """A payload of the JAX package's clients, tampered: both sanitizers
    refuse it with the same message, so the two packages agree on what a
    violation is."""
    jp = jproto.RoundProtocol(mechanism="irwin_hall", sigma=1e-3,
                              packed=True, msg_bits=8)
    n, d = 2, 128
    key = jproto.round_key(3, 1)
    rng = np.random.default_rng(0)
    msgs = np.stack([jp.client_message(
        key, n, p, rng.standard_normal(d).astype(np.float32) * 0.1)
        for p in range(n)])
    geom = dcompress.leaf_geometry(_packed_proto()._comp(), n)
    msgs = _tamper(msgs, geom, (0, 1))
    with jdebug.checks():
        with pytest.raises(jdebug.SanitizeError, match="packed field"):
            jp.decode(key, n, msgs, np.ones(n, bool), d=d)
    with debug.checks():
        with pytest.raises(debug.SanitizeError, match="packed field"):
            _packed_proto().decode(protocol.round_key(3, 1), n,
                                   torch.from_numpy(msgs), np.ones(n, bool),
                                   d=d)
