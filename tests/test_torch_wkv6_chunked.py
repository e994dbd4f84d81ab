"""The chunked form of the RWKV-6 recurrence (``ref.wkv6_chunked_ref`` /
``ref.wkv6_chunked_bwd_ref``, the algorithm of the chunked ``wkv6``
kernels on the card) against the serial form and against the JAX
package's recurrence (``repro.models.rwkv6._wkv_scan`` and ``jax.grad``
of it), and the rule that sends a call to the step kernel or to the
chunked kernels.  The inputs are drawn with numpy from a seed; the bar for
each output is its error from an f64 run of the serial form, at most
twice the plain f32 serial version's (the chunked form sums in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as wk

RATIO = 2.0  # chip_smoke.WKV_RATIO
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
OUTPUTS = ("dr", "dk", "dv", "dw", "du", "dS0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors, as
    tests/test_torch_rwkv6.py: the test workers share the machine's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(B, T, H, K, seed, extreme=False):
    """r, k, v (B, T, H, K), w in [0, 1], u (H, K), a first state, dy and
    the final state's gradient, f32 numpy.  ``extreme``: w = exp(-exp(2 z
    + 1)) (a log decay of about -20 a step, some w underflowing to 0), then
    5% of w set to exactly 0 and 5% to exactly 1."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, T, H, K)) for _ in range(4))
    if extreme:
        w = np.exp(-np.exp(2.0 * rng.standard_normal((B, T, H, K)) + 1.0))
        m = rng.random((B, T, H, K))
        w = np.where(m < 0.05, 0.0, np.where(m > 0.95, 1.0, w))
    else:
        w = np.exp(-np.exp(0.5 * rng.standard_normal((B, T, H, K)) - 0.5))
    u = 0.5 * rng.standard_normal((H, K))
    s0 = 0.3 * rng.standard_normal((B, H, K, K))
    ds = 0.1 * rng.standard_normal((B, H, K, K))
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u, s0, dy, ds))


def _err(a, want) -> float:
    a, want = a.double(), want.double()
    return float((a - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _outputs(r, k, v, w, u, s0, dy, ds):
    """{name: (mirror, plain f32, f64)} of every output: y, the final
    state, each chunk state after the first, and the gradient."""
    ym, sm, cm = ref.wkv6_chunked_ref(r, k, v, w, u, s0)
    yp, sp, cp = ref.wkv6_ref(r, k, v, w, u, s0, return_chunks=True)
    y64, s64, c64 = ref.wkv6_ref(r, k, v, w, u, s0, dtype=torch.float64,
                                 return_chunks=True)
    gm = ref.wkv6_chunked_bwd_ref(r, k, v, w, u, dy, cm, ds)
    gp = ref.wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds)
    g64 = ref.wkv6_bwd_ref(r, k, v, w, u, dy, s0, ds, dtype=torch.float64)
    out = {"y": (ym, yp, y64), "state": (sm, sp, s64)}
    out.update({f"chunk {c}": (cm[:, :, c], cp[:, :, c], c64[:, :, c])
                for c in range(1, cm.shape[2])})
    out.update({n: t for n, t in zip(OUTPUTS, zip(gm, gp, g64))})
    return out


def _held_to_the_bar(out) -> None:
    for name, (m, p, want) in out.items():
        assert m.dtype == torch.float32 and m.shape == p.shape, name
        assert bool(torch.isfinite(m).all()), name
        em, ep = _err(m, want), _err(p, want)
        assert em <= RATIO * ep, (f"{name}: the mirror {em:.3e} from f64, "
                                  f"the plain f32 version {ep:.3e}")


@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("dt", ["bf16 r, k, v, w", "bf16 r, k, v; f32 w",
                                "f32"])
def test_chunked_mirror_within_twice_the_serial_error(K, dt):
    """A ragged T = 260 (four chunks, the last of 68 steps cut to 4) with a
    first state and a final state's gradient: y, the final state, each
    chunk state, dr, dk, dv, dw, du and dS0 of the mirror at most twice the
    plain f32 version's error from f64, in each dtype pair the model
    passes (the scan path's bf16 decay, the decode path's f32 one, all
    f32)."""
    r, k, v, w, u, s0, dy, ds = (torch.from_numpy(a) for a in
                                 _draw(1, 260, 2, K, seed=K))
    if dt != "f32":
        r, k, v = (a.bfloat16() for a in (r, k, v))
    if dt == "bf16 r, k, v, w":
        w = w.bfloat16()
    out = _outputs(r, k, v, w, u, s0, dy, ds)
    assert sum(n.startswith("chunk ") for n in out) == 4
    _held_to_the_bar(out)


@pytest.mark.parametrize("K", [16, 64])
def test_chunked_mirror_under_extreme_decay(K):
    """w exactly 0 (the serial form's state reset), exactly 1 (no decay)
    and log decays summed far past -88 inside a chunk (where a factored
    e^{G_i - G_j} would overflow): every output finite and within the same
    2x bar, f32, T = 300."""
    r, k, v, w, u, s0, dy, ds = _draw(1, 300, 2, K, seed=10 + K,
                                      extreme=True)
    assert (w == 0).mean() > 0.04 and (w == 1).mean() > 0.04
    logs = np.log(np.where(w > 0, w, 1.0))[:, :256].reshape(1, 4, 64, 2, K)
    assert logs.sum(2).min() < -88.0
    t = torch.from_numpy
    _held_to_the_bar(_outputs(*(t(a) for a in (r, k, v, w, u, s0, dy, ds))))


def test_chunked_mirror_matches_the_reference_scan_and_grad():
    """f32, K = 64, T = 200 (a ragged last chunk; the reference's 128-step
    chunks fall elsewhere), zero first state: the mirror's y and final
    state against the jitted ``_wkv_scan`` within 1e-6 of their max, its
    dr, dk, dv, dw, du against ``jax.grad`` of the scan (with a final
    state's gradient) within 1e-5 of max|g|, as tests/test_torch_rwkv6.py
    holds the plain versions."""
    B, T, H, K = 2, 200, 2, 64
    r, k, v, w, u, _, dy, ds = _draw(B, T, H, K, seed=1)
    flat = [jnp.asarray(a.reshape(B, T, H * K)) for a in (r, k, v, w)]
    scan = jax.jit(lambda *a: jrwkv6._wkv_scan(*a, H, K))
    jy, js = scan(*flat, jnp.asarray(u.reshape(-1)))

    def jloss(r_, k_, v_, w_, u_):
        y, s = jrwkv6._wkv_scan(r_, k_, v_, w_, u_, H, K)
        return (jnp.sum(y * jnp.asarray(dy.reshape(B, T, H * K)))
                + jnp.sum(s * jnp.asarray(ds)))

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *flat, jnp.asarray(u.reshape(-1)))
    t = torch.from_numpy
    y, s, chunks = ref.wkv6_chunked_ref(t(r), t(k), t(v), t(w), t(u))
    assert chunks.shape == (B, H, 4, K, K)

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.abs(got - want).max() / np.abs(want).max())

    assert rel(y.numpy().reshape(B, T, H * K), jy) <= 1e-6
    assert rel(s.numpy(), js) <= 1e-6
    got = ref.wkv6_chunked_bwd_ref(t(r), t(k), t(v), t(w), t(u), t(dy),
                                   chunks, t(ds))
    for a, b in zip(got[:5], jg):
        assert rel(a.numpy().reshape(b.shape), b) <= 1e-5


@pytest.mark.parametrize("T,state,kernel", [
    (1, True, "wkv6_step"), (1, False, "wkv6_fwd"), (2, True, "wkv6_fwd"),
    (70, False, "wkv6_fwd")])
def test_dispatch_rule(T, state, kernel, monkeypatch):
    """``wkv6.uses_step``: one step from a state (the decode step) goes to
    the step kernel, every other call to the chunked forward; under
    autograd the gradient goes to the chunked backward from the chunk
    states the forward kept.  The kernels are replaced by recording plain
    versions and ``_on_cuda`` answers yes, so ``Wkv6`` routes as on the
    card."""
    assert wk.uses_step(T, torch.zeros(1) if state else None) == (
        kernel == "wkv6_step")
    called = []

    def forward(name):
        def run(r, k, v, w, u, s=None, *, chunks=False):
            called.append((name, chunks))
            out = ref.wkv6_ref(r, k, v, w, u, s, return_chunks=True)
            return out if chunks else out[:2]
        return run

    def backward(r, k, v, w, u, dy, chunks, ds=None, *, want_dstate=False):
        called.append(("wkv6_bwd", chunks.shape))
        return ref.wkv6_bwd_ref(r, k, v, w, u, dy, chunks[:, :, 0], ds)

    monkeypatch.setattr(wk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(wk, "wkv6_step", forward("wkv6_step"))
    monkeypatch.setattr(wk, "wkv6_fwd", forward("wkv6_fwd"))
    monkeypatch.setattr(wk, "wkv6_bwd", backward)
    r, k, v, w, u, s0, _, _ = (torch.from_numpy(a) for a in
                               _draw(1, T, 2, 16, seed=3))
    s = s0 if state else None
    with torch.no_grad():
        wk.Wkv6.apply(r, k, v, w, u, s)
    assert called == [(kernel, False)]
    called.clear()
    r.requires_grad_()
    y, _ = wk.Wkv6.apply(r, k, v, w, u, s)
    y.sum().backward()
    assert called == [(kernel, True),
                      ("wkv6_bwd", (1, 2, wk.n_chunks(T), 16, 16))]
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())
