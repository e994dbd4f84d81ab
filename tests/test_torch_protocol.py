"""The slice as a whole: the port's round protocol, compress codec and FL
loop against the JAX package's, on the CPU, for the same (seed, rnd).

Tolerances:
  * payloads, packed and unpacked, are integer words: equal (the shared
    (A, B) and the dither are the reference's bit for bit, see
    tests/test_torch_aggregate.py);
  * decoded means: 1e-6, the reference's fused-decode tolerance (the
    reference contracts (u - s) * step + offset into one FMA, the port
    rounds twice; the means are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import ks_statistic, ks_threshold, norm_cdf
from repro.dist import compress as jcomp
from repro.fl import federated as jfl
from repro.runtime import protocol as jproto
from repro.runtime.workloads import QuadraticWorkload as JQuad
from repro_torch import convert
from repro_torch.dist import compress as tcomp
from repro_torch.fl import federated as tfl
from repro_torch.runtime import protocol as tproto
from repro_torch.runtime.workloads import QuadraticWorkload as TQuad

DECODE_ATOL = 1e-6
HOMOMORPHIC = ["irwin_hall", "aggregate_gaussian", "aggregate_laplace"]
INDIVIDUAL = ["individual_shifted", "individual_direct"]


def _keys(seed, rnd):
    jk = jproto.round_key(seed, rnd)
    tk = convert.key_from_numpy(np.asarray(jk))
    assert torch.equal(tk, tproto.round_key(seed, rnd))
    return jk, tk


def _protos(mechanism, packed, sigma=1e-3, bits=8):
    kw = dict(mechanism=mechanism, sigma=sigma, packed=packed,
              msg_bits=bits if packed else None)
    return jproto.RoundProtocol(**kw), tproto.RoundProtocol(**kw,
                                                             device="cpu")


def _messages(jp, tp, jk, tk, xs):
    n = xs.shape[0]
    jm = np.stack([jp.client_message(jk, n, p, xs[p]) for p in range(n)])
    tm = torch.stack([tp.client_message(tk, n, p, torch.from_numpy(xs[p]))
                      for p in range(n)])
    return jm, tm


@pytest.mark.parametrize("mechanism", HOMOMORPHIC)
@pytest.mark.parametrize("packed", [True, False])
def test_payloads_and_decode_match(mechanism, packed):
    d, n = 4096, 6
    jk, tk = _keys(3, 11)
    jp, tp = _protos(mechanism, packed)
    xs = np.random.default_rng(0).uniform(-1, 1, (n, d)).astype(np.float32)
    jm, tm = _messages(jp, tp, jk, tk, xs)
    assert tm.dtype == torch.int32 and tuple(tm.shape) == jm.shape
    assert tm.shape[-1] == tp.payload_size(n, d) == jp.payload_size(n, d)
    differ = int((tm.numpy() != jm).sum())
    assert differ == 0, f"{differ} payload words differ"
    mask = np.ones(n, bool)
    y_ref, bits_ref = jp.decode(jk, n, jm, mask, d=d)
    y, bits = tp.decode(tk, n, torch.from_numpy(jm.copy()), mask, d=d)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=DECODE_ATOL)
    assert bits == pytest.approx(bits_ref, rel=1e-6)
    if packed:
        assert bits == 32.0 * tm.shape[-1] / d


@pytest.mark.parametrize("mechanism", INDIVIDUAL)
@pytest.mark.parametrize("straggle", [False, True])
@pytest.mark.parametrize("msg_dtype", ["int32", "int16"])
def test_individual_payloads_and_decode(mechanism, straggle, msg_dtype):
    """The layered mechanisms on the unpacked wire: payloads bitwise; the
    server decodes client by client (the reference vmaps the cohort) and
    the mean equals the reference's, bitwise here (bar: 1e-6), with or
    without stragglers; Elias-gamma bits per coordinate equal."""
    d, n = 4096, 6
    jk, tk = _keys(3, 11)
    kw = dict(mechanism=mechanism, sigma=1e-3, msg_dtype=msg_dtype)
    jp = jproto.RoundProtocol(**kw)
    tp = tproto.RoundProtocol(**kw, device="cpu")
    xs = np.random.default_rng(0).uniform(-1, 1, (n, d)).astype(np.float32)
    jm, tm = _messages(jp, tp, jk, tk, xs)
    assert tm.dtype == getattr(torch, msg_dtype)
    assert np.array_equal(tm.numpy(), jm)
    mask = np.ones(n, bool)
    if straggle:
        mask[[1, 4]] = False
    m2 = np.where(mask[:, None], jm, 0)
    y_ref, bits_ref = jp.decode(jk, n, m2, mask)
    y, bits = tp.decode(tk, n, torch.from_numpy(m2), mask)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=DECODE_ATOL)
    assert np.array_equal(y.numpy(), np.asarray(y_ref))
    assert bits == pytest.approx(bits_ref, rel=1e-6)
    err = y.numpy() - xs[mask].mean(0)
    assert abs(err.mean()) < 5e-3 * np.sqrt(n) and err.std() < 3e-3 * n


@pytest.mark.parametrize("mechanism", HOMOMORPHIC)
def test_straggler_mask_decode(mechanism):
    """Decode of the realized subset: announced-n step and geometry,
    realized-r divisor and bias count (test_fused_compress.py:215, at its
    default 24-bit fields)."""
    d, n, sigma = 4096, 6, 1e-3
    jk, tk = _keys(3, 11)
    jp, tp = _protos(mechanism, True, sigma, bits=None)
    xs = np.random.default_rng(0).uniform(-1, 1, (n, d)).astype(np.float32)
    jm, tm = _messages(jp, tp, jk, tk, xs)
    mask = np.ones(n, bool)
    mask[[0, 3]] = False
    m2 = np.where(mask[:, None], jm, 0)
    y_ref, _ = jp.decode(jk, n, m2, mask, d=d)
    y, _ = tp.decode(tk, n, torch.from_numpy(m2), mask, d=d)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=DECODE_ATOL)
    err = y.numpy() - xs[mask].mean(0)
    assert abs(err.mean()) < 5 * sigma and err.std() < 3 * sigma


def test_packed_error_law_ks():
    """The packed aggregate error is N(0, sigma^2) (as
    test_fused_compress.py:245, the reference's own cell)."""
    d, n, sigma = 1 << 15, 6, 1e-3
    _, tk = _keys(0, 7)
    tp = tproto.RoundProtocol(mechanism="aggregate_gaussian", sigma=sigma,
                              packed=True, device="cpu")
    xs = np.random.default_rng(1).uniform(-1, 1, (n, d)).astype(np.float32)
    tm = torch.stack([tp.client_message(tk, n, p, torch.from_numpy(xs[p]))
                      for p in range(n)])
    y, _ = tp.decode(tk, n, tm, np.ones(n, bool), d=d)
    err = y.numpy() - xs.mean(0)
    assert ks_statistic(err, lambda t: norm_cdf(t, sigma)) < ks_threshold(d)


@pytest.mark.parametrize("mechanism", ["irwin_hall", "aggregate_gaussian"])
def test_federated_rounds_match(mechanism):
    """FederatedAveraging over QuadraticWorkload, 3 packed rounds: the
    parameters match the reference's within the decode tolerance."""
    d, n = 4096, 4
    cfg = dict(n_clients=n, mechanism=mechanism, sigma=1e-2, lr=0.5,
               seed=0, mech_kwargs=(("packed", True), ("msg_bits", 8)))
    jgrad = JQuad(n, d).build()
    tw = TQuad(n, d)
    jfa = jfl.FederatedAveraging(
        jfl.FLConfig(**cfg),
        lambda p, c, r: jnp.asarray(jgrad(np.asarray(p), c, r)))
    tfa = tfl.FederatedAveraging(tfl.FLConfig(**cfg), tw.build(device="cpu"),
                                 device="cpu")
    jparams, _ = jfa.run(jnp.zeros(d, jnp.float32), 3)
    tparams, info = tfa.run(tw.init_params(device="cpu"), 3)
    assert info["cohort"] == n and info["bits_per_coord"] == 8.0
    np.testing.assert_allclose(tparams.numpy(), np.asarray(jparams), rtol=0,
                               atol=DECODE_ATOL)


@pytest.mark.parametrize("mechanism", INDIVIDUAL + ["sigm", "none"])
def test_federated_individual_rounds_match(mechanism):
    """Sync rounds over QuadraticWorkload for the layered mechanisms on
    the unpacked wire (the codec) and the central estimators (SIGM,
    none), with client subsampling and stragglers: parameters match the
    reference's within the decode tolerance, bits per coordinate too."""
    d, n = 2048, 5
    cfg = dict(n_clients=n, mechanism=mechanism, sigma=1e-2, lr=0.5,
               seed=1, cohort_fraction=0.9, straggler_fraction=0.2)
    jgrad = JQuad(n, d).build()
    tw = TQuad(n, d)
    jfa = jfl.FederatedAveraging(
        jfl.FLConfig(**cfg),
        lambda p, c, r: jnp.asarray(jgrad(np.asarray(p), c, r)))
    tfa = tfl.FederatedAveraging(tfl.FLConfig(**cfg), tw.build(device="cpu"),
                                 device="cpu")
    jp, tparams = jnp.zeros(d, jnp.float32), tw.init_params(device="cpu")
    for rnd in range(3):
        jp, jinfo = jfa.round(jp, rnd)
        tparams, tinfo = tfa.round(tparams, rnd)
        assert tinfo["cohort"] == jinfo["cohort"]
        assert tinfo["bits_per_coord"] == pytest.approx(
            jinfo["bits_per_coord"], rel=1e-6)
    np.testing.assert_allclose(tparams.numpy(), np.asarray(jp), rtol=0,
                               atol=DECODE_ATOL)


def test_federated_dict_updates():
    """Updates may be dicts of tensors: flattened in the reference's
    (sorted-key) order and rebuilt onto the parameter structure."""
    d = 300
    params = {"w": torch.zeros(10, 20), "b": torch.zeros(100)}
    cfg = tfl.FLConfig(n_clients=3, mechanism="irwin_hall", sigma=1e-2,
                       mech_kwargs=(("packed", True),))
    targets = torch.linspace(-0.5, 0.5, d)

    def grad(p, c, rnd):
        return {"b": p["b"] - targets[:100], "w": p["w"] - targets[100:]
                .reshape(10, 20)}

    fa = tfl.FederatedAveraging(cfg, grad, device="cpu")
    new, info = fa.round(params, 0)
    assert set(new) == {"w", "b"} and new["w"].shape == (10, 20)
    assert float((new["b"] - 0.1 * targets[:100]).abs().max()) < 0.1


@pytest.mark.parametrize("packed", [True, False])
def test_decode_releases_the_shared_draw(packed):
    """The round's shared (A, B) serves every encode, and decode, its last
    user, drops it: at full width it is gigabytes of device memory."""
    d, n = 512, 3
    _, tk = _keys(2, 5)
    tp = tproto.RoundProtocol(mechanism="aggregate_gaussian", sigma=1e-2,
                              packed=packed, device="cpu")
    xs = torch.zeros(n, d)
    tm = torch.stack([tp.client_message(tk, n, p, xs[p]) for p in range(n)])
    assert len(tproto._SHARED) == 1
    tp.decode(tk, n, tm, np.ones(n, bool), d=d)
    assert not tproto._SHARED


@pytest.mark.parametrize("mechanism", HOMOMORPHIC)
@pytest.mark.parametrize("fused", [True, False])
def test_compress_tree_point_to_point(mechanism, fused):
    grads = {"a": np.random.default_rng(2).normal(0, 0.5, (64, 33))
             .astype(np.float32),
             "b": np.random.default_rng(3).normal(0, 0.5, (517,))
             .astype(np.float32)}
    kw = dict(mechanism=mechanism, sigma=1e-2, fused=fused,
              msg_bits=16 if fused else None)
    key = jax.random.PRNGKey(4)
    # compiled, as every caller runs it (inside the train step's jit)
    ref = jax.jit(lambda g, k: jcomp.compress_tree(
        g, jcomp.CompressionConfig(**kw), k))(
        {k: jnp.asarray(v) for k, v in grads.items()}, key)
    out = tcomp.compress_tree(convert.params_from_numpy(grads, "cpu"),
                              tcomp.CompressionConfig(**kw),
                              convert.key_from_numpy(np.asarray(key)),
                              device="cpu")
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=DECODE_ATOL)


@pytest.mark.parametrize("mechanism", HOMOMORPHIC)
def test_bit_accounting_matches(mechanism):
    for fused, bits in ((True, 8), (True, None), (False, None)):
        kw = dict(mechanism=mechanism, sigma=0.05, fused=fused,
                  msg_bits=bits)
        jc, tc = jcomp.CompressionConfig(**kw), tcomp.CompressionConfig(**kw)
        assert tcomp.leaf_geometry(tc, 4) == jcomp.leaf_geometry(jc, 4)
        for size in (None, 1000):
            assert tcomp.wire_bits_per_coord(tc, 4, size) == \
                jcomp.wire_bits_per_coord(jc, 4, size)
    tc = tcomp.CompressionConfig(mechanism=mechanism, sigma=0.05)
    jc = jcomp.CompressionConfig(mechanism=mechanism, sigma=0.05)
    assert tcomp.message_bits(tc, 4, device="cpu") == pytest.approx(
        jcomp.message_bits(jc, 4), rel=1e-6)


def test_dither_keys_match():
    jk, tk = _keys(5, 2)
    assert np.array_equal(tproto.expected_dither_keys(tk, 7),
                          jproto.expected_dither_keys(jk, 7))
    assert np.array_equal(tproto.client_dither_key(tk, 7, 3).numpy(),
                          np.asarray(jproto.client_dither_key(jk, 7, 3)))


def test_sample_cohort_matches():
    for rnd in range(5):
        assert np.array_equal(tfl.sample_cohort(20, 0.5, 0.2, 3, rnd),
                              jfl.sample_cohort(20, 0.5, 0.2, 3, rnd))


def test_unported_paths_raise():
    """What the port refuses raises: a packed uplink of a non-homomorphic
    mechanism (the reference's ValueError), the JAX package's mesh axis
    name where the port takes a process group of client ranks (the
    process-group sum and checkpointing are ported, see
    tests/test_torch_dist.py and tests/test_torch_checkpoint.py), and a
    packed decode without the update dim."""
    with pytest.raises(ValueError, match="homomorphic"):
        tproto.RoundProtocol(mechanism="individual_shifted", packed=True,
                             device="cpu")
    with pytest.raises(ValueError):
        jproto.RoundProtocol(mechanism="individual_shifted", packed=True)
    with pytest.raises(TypeError, match="ProcessGroup"):
        tcomp.compress_tree(torch.zeros(8), tcomp.CompressionConfig(),
                            tproto.round_key(0, 0), axis="pod", device="cpu")
    with pytest.raises(ValueError, match="needs the update dim"):
        tproto.RoundProtocol(mechanism="irwin_hall", packed=True,
                             device="cpu").decode(
            tproto.round_key(0, 0), 2, torch.zeros((2, 128)), [True, True])


def test_entry_points_need_a_card_unless_cpu_is_asked():
    """With no CUDA device, entry points raise unless device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tproto.RoundProtocol(mechanism="irwin_hall")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.FederatedAveraging(tfl.FLConfig(n_clients=2), lambda p, c, r: p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcomp.compress_tree(torch.zeros(8), tcomp.CompressionConfig(),
                            tproto.round_key(0, 0))

