"""The port's sliding-window attention (zamba2's shared attention) against
the JAX package: the plain flash forward in f32 and in bf16 (at the smoke
configs' kv_chunk 8 and the full configs' 1024) and the plain backward,
with a window, against the JAX model's ``flash_attention(window=)`` and
its ``jax.vjp``; head dim 112 (zamba2-7b's) in bf16; the window's
plumbing through ``ops.flash_attention``'s autograd function and the
model's attention; and the windows the kernels refuse.  Inputs are made
with numpy from a seed and handed to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

# the bars of tests/test_torch_flash_attention.py: f32 sums in other
# orders; bf16 every output within one ulp + 2^-9 max|v| and 99% within one
# ulp + 2e-5 where both sides round P against the same chunks
ATOL = 2e-5
BF16_P_BAR = 2.0 ** -9
BF16_SHARE = 0.99
GRAD_REL = 2e-5

# (B, T, H, HK, D, window): a window < T and a multiple of the small chunk,
# one that is not (and smaller than the 1024 chunk), one >= T, and GQA
CASES = [
    (2, 96, 4, 2, 16, 32),
    (1, 130, 4, 4, 32, 37),
    (1, 64, 2, 1, 64, 64),
    (1, 80, 4, 2, 16, 200),
]


def _qkv(B, T, S, H, HK, D, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    v = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _bf16(*arrays):
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                for t in ts]


def _bf16_check(got, want, v):
    want = torch.as_tensor(np.array(want, dtype=np.float32))
    diff = (got.float() - want).abs()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    bar = ulp + BF16_P_BAR * float(v.float().abs().max())
    assert int((diff > bar).sum()) == 0, float(diff.max())
    share = float((diff <= ulp + ATOL).float().mean())
    assert share >= BF16_SHARE, share


def _jax(q, k, v, window, chunk):
    out = jattn.flash_attention(q, k, v, causal=True, window=window,
                                q_chunk=chunk, kv_chunk=chunk)
    return np.array(out.astype(jnp.float32))


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,T,H,HK,D,window", CASES)
def test_f32_window_matches_the_jax_model(B, T, H, HK, D, window):
    """f32: the plain forward with a window (``ref.flash_attention_ref``,
    the CPU path of ``ops.flash_attention``) within 2e-5 of the JAX
    model's attention with the same window (chunks of 16)."""
    q, k, v = _qkv(B, T, T, H, HK, D)
    want = _jax(*map(jnp.asarray, (q, k, v)), window, 16)
    got = ops.flash_attention(*_t(q, k, v), kv_tile=1024, window=window)
    assert float(np.abs(got.numpy() - want).max()) <= ATOL


@pytest.mark.parametrize("chunk", [8, 1024])
@pytest.mark.parametrize("B,T,H,HK,D,window", CASES + [
    (1, 160, 4, 2, 112, 40), (1, 48, 2, 2, 112, 48)])
def test_bf16_window_matches_the_jax_model(B, T, H, HK, D, window, chunk):
    """bf16 at the smoke configs' kv_chunk 8 and the full configs' 1024,
    head dim 112 among the cases: the plain bf16 forward at the JAX
    model's chunk against its bf16 attention with the same window, P
    rounded against the same running max (chunks wholly outside a row's
    window included, as the JAX model runs them): every output within one
    ulp + 2^-9 max|v| and 99% within one ulp + 2e-5."""
    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(B, T, T, H, HK, D, seed=7))
    want = _jax(jq, jk, jv, window, chunk)
    got = attention.flash_attention(q, k, v, window=window, kv_chunk=chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, D)
    _bf16_check(got, want, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_at_least_t_is_no_window(dtype):
    """A window >= T masks nothing: the plain forward and backward give
    the bits of no window, in both dtypes; a window of 1 attends each
    query to itself alone (the output is v, row for row)."""
    q, k, v = (x.to(dtype) for x in _t(*_qkv(1, 40, 40, 2, 2, 16)))
    do = torch.ones_like(q)
    for window in (40, 1000):
        outs = []
        for w in (0, window):
            o, lse = (ref.flash_attention_bf16_ref(
                q, k, v, True, kv_tile=8, return_lse=True, window=w)
                if dtype == torch.bfloat16 else ref.flash_attention_ref(
                    q, k, v, True, return_lse=True, window=w))
            grads = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True,
                                                window=w)
            outs.append((o, lse) + tuple(grads))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    one = ops.flash_attention(q, k, v, kv_tile=8, window=1)
    assert torch.equal(one, v.to(dtype))


@pytest.mark.parametrize("B,T,H,HK,D,window", CASES)
def test_f32_window_backward_matches_jax_vjp(B, T, H, HK, D, window):
    """f32: ``flash_attention_bwd_ref`` with a window, from the plain
    forward's output and lse, against ``jax.vjp`` of the JAX model's
    attention with the same window, within 2e-5 max|g|."""
    q, k, v = _qkv(B, T, T, H, HK, D, seed=9)
    do = np.random.default_rng(10).standard_normal(q.shape).astype(
        np.float32)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = ref.flash_attention_ref(tq, tk, tv, True, return_lse=True,
                                     window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, True,
                                      kv_tile=16, window=window)

    def fn(q, k, v):
        return jattn.flash_attention(q, k, v, causal=True, window=window,
                                     q_chunk=16, kv_chunk=16)

    _, pull = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, pull(jnp.asarray(do))):
        assert g.shape == w.shape
        assert _max_rel(g.numpy(), w) <= GRAD_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_carries_the_window(dtype):
    """``ops.flash_attention`` under autograd with a window gives the
    plain forward's output and exactly the plain backward's gradients
    with the same window (the window travels in ``ctx``), which differ
    from the gradients without it."""
    q, k, v = _t(*_qkv(1, 48, 48, 4, 2, 32, seed=12))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    tq, tk, tv, tdo = (t.to(dtype) for t in (q, k, v, do))
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*xs, True, kv_tile=16, window=20)
    out.backward(tdo)
    if dtype == torch.bfloat16:
        o, lse = ref.flash_attention_bf16_ref(tq, tk, tv, True, kv_tile=16,
                                              return_lse=True, window=20)
    else:
        o, lse = ref.flash_attention_ref(tq, tk, tv, True, return_lse=True,
                                         window=20)
    assert torch.equal(out.detach(), o)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, True,
                                       window=20)
    unwindowed = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, True)
    for x, g, g0 in zip(xs, want, unwindowed):
        assert x.grad.dtype == dtype
        assert torch.equal(x.grad, g)
        assert not torch.equal(g, g0)


def test_bf16_head_dim_112_gradient_error_at_most_twice_the_jax_models():
    """bf16 at head dim 112 with a window (zamba2-7b's head width): the
    port's gradient (plain forward at kv_chunk 32, plain backward) and the
    JAX model's bf16 gradient (``jax.vjp``) against the JAX model's f32
    gradient of the same bf16 values; the port's relative L2 error is at
    most twice the JAX model's, for dq, dk and dv, and its forward meets
    the bf16 bars; bf16(112^-1/2) is the scale (not exact in bf16)."""
    B, T, H, HK, D, W, C = 1, 192, 4, 2, 112, 70, 32
    assert ref.bf16_scale(D) != D ** -0.5
    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(B, T, T, H, HK, D, seed=14))
    dob, (jdo,) = _bf16(np.random.default_rng(15).standard_normal(
        (B, T, H, D)).astype(np.float32))

    def fn(q, k, v):
        return jattn.flash_attention(q, k, v, causal=True, window=W,
                                     q_chunk=C, kv_chunk=C)

    f32 = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    _, pull32 = jax.vjp(fn, *f32)
    want = [np.asarray(g) for g in pull32(jdo.astype(jnp.float32))]
    jout, pull = jax.vjp(fn, jq, jk, jv)
    jgot = [np.asarray(g.astype(jnp.float32)) for g in pull(jdo)]
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*xs, True, kv_tile=C, window=W)
    _bf16_check(out.detach(), np.asarray(jout.astype(jnp.float32)), v)
    out.backward(dob[0])

    def l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for x, jg, w in zip(xs, jgot, want):
        assert l2(x.grad.float().numpy(), w) <= 2 * l2(jg, w)


def test_windows_the_kernels_refuse():
    """A negative window, a window without the causal mask, or one with
    T > S raise on the CPU as on the card; None and 0 are no window; the
    model's attention still refuses a query offset."""
    q, k, v = _t(*_qkv(1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="< 0"):
        ops.flash_attention(q, k, v, kv_tile=8, window=-1)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, k, v, False, kv_tile=8, window=4)
    with pytest.raises(ValueError, match="T <= S"):
        ops.flash_attention(q, k[:, :4], v[:, :4], kv_tile=8, window=4)
    assert fa.check_window(None, True, 8, 8) == 0
    base = ops.flash_attention(q, k, v, kv_tile=8)
    assert torch.equal(attention.flash_attention(q, k, v, window=None,
                                                 kv_chunk=8), base)
    with pytest.raises(NotImplementedError, match="offset"):
        attention.flash_attention(q, k, v, q_offset=3, window=4)
