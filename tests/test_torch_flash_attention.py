"""The port's attention against the JAX package: the plain flash
attention (the CPU path of ``ops.flash_attention``, and the yardstick of
the CUDA kernels on the card) in f32 against the Pallas kernel in
interpret mode and against ``mha_ref``, and in bf16 against the JAX
model's attention (``repro.models.attention.flash_attention``) in bf16;
``decode_attention`` in its three mask modes; the dispatch by dtype; the
shapes and masks the port refuses; and the error budgets of the f32
kernel's 3xTF32 design and of the bf16 backward kernel's split dS, by CPU
emulations of their arithmetic.  Inputs are made with numpy from
a seed and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention

# the reference's own bar for the flash kernel (tests/test_kernels.py);
# both sides sum in f32 in different orders
ATOL = 2e-5
# bf16 bars.  P is rounded to bf16 before P V; a p that rounds to the
# other bf16 neighbour moves an output by at most 2^-9 max|v|, and the
# output's own rounding by one bf16 ulp: every output within one ulp of
# the reference + 2^-9 max|v|.  Where both sides round P against the
# same running max (the same KV tiles), the rest is f32 summation order:
# at least 99% of outputs within one ulp + ATOL (measured 99.98-100%).
BF16_P_BAR = 2.0 ** -9
BF16_SHARE = 0.99
# the bf16 kernel's key tile: a kv_chunk of one tile is its single pass
TILE = 128
# the full configs' kv_chunk, passed where the function (f32) has no tiling
KV = 1024


def _qkv(B, T, S, H, HK, D, seed=11):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    v = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _pallas(q, k, v, causal):
    """The Pallas kernel in interpret mode, through the reference's ops
    wrapper (GQA repeat and padding to 64-blocks)."""
    return np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=64, bk=64, interpret=True))


def _bf16(*arrays):
    """The same bf16 values for both sides: torch tensors and jnp arrays."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                for t in ts]


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (2^(e - 8) for |x| = m 2^e,
    m in [0.5, 1))."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _bf16_check(got, want, v, share_bar=BF16_SHARE):
    """Every output within one ulp + BF16_P_BAR max|v| of ``want``, and
    at least ``share_bar`` of them within one ulp + ATOL; returns the
    share."""
    want = torch.as_tensor(np.array(want, dtype=np.float32))
    diff = (got.float() - want).abs()
    ulp = _bf16_ulp(want)
    bar = ulp + BF16_P_BAR * float(v.float().abs().max())
    assert int((diff > bar).sum()) == 0, float(diff.max())
    share = float((diff <= ulp + ATOL).float().mean())
    assert share >= share_bar, share
    return share


def _jax_bf16(jq, jk, jv, causal, chunk, kv_chunk):
    out = jattn.flash_attention(jq, jk, jv, causal=causal, q_chunk=chunk,
                                kv_chunk=kv_chunk)
    return np.array(out.astype(jnp.float32))


# test_kernels.py's four shapes, two more GQA cases at D = 128 and two
# ragged causal cases with T != S (the Pallas mask, aligned top left:
# with T > S the queries past the last key see every key)
PALLAS_CASES = [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 2, 2, 32, True),
    (2, 64, 192, 4, 4, 16, False),
    (1, 96, 96, 2, 1, 128, True),
    (2, 80, 80, 8, 2, 128, True),
    (1, 64, 64, 4, 1, 128, False),
    (1, 48, 100, 2, 2, 32, True),
    (2, 100, 48, 4, 2, 64, True),
]


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", PALLAS_CASES)
def test_plain_matches_pallas_kernel(B, T, S, H, HK, D, causal):
    """The port's flash attention on the CPU equals the Pallas kernel
    (interpret mode, through the reference's ops wrapper: GQA repeat and
    padding to 64-blocks) within 2e-5."""
    q, k, v = _qkv(B, T, S, H, HK, D)
    want = _pallas(q, k, v, causal)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, kv_tile=KV)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,T,S,H,HK,D,causal",
                         [c for c in PALLAS_CASES if c[1] == c[2]])
def test_plain_matches_mha_ref_where_t_equals_s(B, T, S, H, HK, D, causal):
    """Against the reference oracle ``mha_ref`` (bottom-right causal
    mask), which agrees with the kernel's top-left mask when T == S; the
    port's own ``mha_ref`` too."""
    q, k, v = _qkv(B, T, S, H, HK, D, seed=3)
    kr, vr = np.repeat(k, H // HK, 2), np.repeat(v, H // HK, 2)
    want = np.asarray(jref.mha_ref(jnp.asarray(q), jnp.asarray(kr),
                                   jnp.asarray(vr), causal=causal))
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    got_mha = ref.mha_ref(*_t(q, kr, vr), causal=causal)
    np.testing.assert_allclose(got_mha.numpy(), want, atol=ATOL, rtol=0)


def test_causal_mask_is_aligned_top_left():
    """With T < S, query i sees keys 0..i: the output equals attention
    over the first T keys alone (the Pallas kernel's convention, not
    mha_ref's bottom-right one)."""
    q, k, v = _qkv(1, 8, 20, 2, 2, 16, seed=4)
    full = ops.flash_attention(*_t(q, k, v), kv_tile=KV)
    head = ops.flash_attention(*_t(q, k[:, :8], v[:, :8]), kv_tile=KV)
    np.testing.assert_allclose(full.numpy(), head.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("path", ["ops", "model"])
@pytest.mark.parametrize("B,T,S,H,HK,D,causal", PALLAS_CASES)
def test_bf16_in_bf16_out(B, T, S, H, HK, D, causal, path):
    """bf16 in, bf16 out: the port's bf16 function (the CPU path of
    ``ops.flash_attention`` and of the model's attention) against the JAX
    model's attention in bf16 with q_chunk 32 and kv_chunk 128, the KV
    tile of the port's function, so that both round P against the same
    running max: every output within one ulp + 2^-9 max|v|, and 99%
    within one ulp + 2e-5 (measured 99.979-100%)."""
    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(B, T, S, H, HK, D))
    want = _jax_bf16(jq, jk, jv, causal, 32, TILE)
    if path == "ops":
        got = ops.flash_attention(q, k, v, causal=causal, kv_tile=TILE)
    else:
        got = attention.flash_attention(q, k, v, causal=causal,
                                        kv_chunk=TILE)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, D)
    _bf16_check(got, want, v)


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("B,T,S,H,HK,D,causal", PALLAS_CASES)
def test_bf16_kv_tiling_rounds_p(B, T, S, H, HK, D, causal, chunk):
    """The KV tiling is part of the bf16 function: P is rounded against
    the running max of the tiles seen so far.  With the JAX model's small
    chunks (the shipped configs take 8), the plain version at the same
    tile meets both bars (measured 99.989-100% within one ulp + 2e-5); at
    its own 128-key tile only the P bar holds (measured 92.3-94.5% at
    chunk 8, 93.7-98.7% at 32): a p rounded to the other bf16 neighbour
    against another running max."""
    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(B, T, S, H, HK, D, seed=13))
    want = _jax_bf16(jq, jk, jv, causal, chunk, chunk)
    own = ref.flash_attention_bf16_ref(q, k, v, causal, kv_tile=TILE)
    _bf16_check(own, want, v, share_bar=0.0)
    same = ref.flash_attention_bf16_ref(q, k, v, causal, kv_tile=chunk)
    _bf16_check(same, want, v)


def test_bf16_scale_rounds_as_the_jax_model(monkeypatch):
    """The JAX model scales bf16 q by the Python float D**-0.5, which it
    takes as a bf16 scalar (attention.py:46): at D = 128 that is
    bf16(128^-1/2) = 0.08837890625, not f32(128^-1/2).  The port's scaled
    q equals the JAX model's bitwise on 4096 values, where scaling by the
    f32 value rounds some of them differently; and the whole function
    equals the JAX model's output exactly on at least 99% of outputs
    (measured 99.4%), where an f32-scale version would on at most 90%
    (measured 67.7%)."""
    assert ref.bf16_scale(128) == 0.08837890625 != np.float32(128 ** -0.5)
    assert ref.bf16_scale(64) == 0.125  # a power of two: exact either way
    (q,), (jq,) = _bf16(_qkv(1, 32, 1, 1, 1, 128, seed=14)[0])
    want = np.array((jq * 128 ** -0.5).astype(jnp.float32))
    np.testing.assert_array_equal(ref.scale_q_bf16(q).float().numpy(), want)
    f32_scaled = (q.float() * (128 ** -0.5)).to(torch.bfloat16).float()
    assert int((f32_scaled.numpy() != want).sum()) > 0

    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(2, 80, 80, 8, 2, 128))
    want = torch.from_numpy(_jax_bf16(jq, jk, jv, True, 32, 128))
    got = ref.flash_attention_bf16_ref(q, k, v, True, kv_tile=TILE).float()
    assert float((got == want).float().mean()) >= 0.99
    monkeypatch.setattr(ref, "scale_q_bf16", lambda x: (
        x.float() * (x.shape[-1] ** -0.5)).to(torch.bfloat16))
    f32_scale = ref.flash_attention_bf16_ref(q, k, v, True,
                                             kv_tile=TILE).float()
    assert float((f32_scale == want).float().mean()) <= 0.9


@pytest.mark.parametrize("B,T,S,H,HK,D,causal",
                         [c for c in PALLAS_CASES if c[5] < 128])
def test_bf16_plain_differs_from_pallas_by_p_rounding(B, T, S, H, HK, D,
                                                      causal):
    """Against the Pallas kernel in interpret mode, bf16 in: at D <= 64
    the scale is a power of two, so q scales exactly on both sides, and
    with the same 64-key tiles the only change of function is P rounded
    to bf16 (the Pallas kernel keeps P in f32).  The looser bar: the P
    bar alone, every output within one ulp + 2^-9 max|v| (measured
    84.6-90.8% within one ulp + 2e-5)."""
    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(B, T, S, H, HK, D, seed=15))
    want = np.array(jops.flash_attention(jq, jk, jv, causal=causal, bq=64,
                                         bk=64, interpret=True)
                    .astype(jnp.float32))
    got = ref.flash_attention_bf16_ref(q, k, v, causal, kv_tile=64)
    _bf16_check(got, want, v, share_bar=0.0)


def test_cpu_dispatch_by_dtype():
    """On the CPU, ``ops.flash_attention`` computes each dtype's function
    with its plain version, bitwise: f32 the Pallas kernel's
    (``flash_attention_ref``), bf16 the JAX model's
    (``flash_attention_bf16_ref``)."""
    q, k, v = _t(*_qkv(1, 40, 40, 4, 2, 64, seed=5))
    assert torch.equal(ops.flash_attention(q, k, v, kv_tile=KV),
                       ref.flash_attention_ref(q, k, v))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(qb, kb, vb, kv_tile=KV)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.flash_attention_bf16_ref(qb, kb, vb,
                                                         kv_tile=KV))


@pytest.mark.parametrize("D", [8, 48, 256])
def test_unsupported_head_dim_raises(D):
    q, k, v = _t(*_qkv(1, 4, 4, 2, 2, D))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v, kv_tile=KV)


def test_unsupported_shapes_and_types_raise():
    q, k, v = _t(*_qkv(1, 4, 4, 3, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v, kv_tile=KV)
    q, k, v = _t(*_qkv(1, 4, 4, 2, 2, 16))
    with pytest.raises(TypeError, match="share one dtype"):
        ops.flash_attention(q.double(), k.double(), v.double(), kv_tile=KV)
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, k, v[:, :3], kv_tile=KV)


def test_model_attention_refuses_other_masks():
    """A query offset raises on every device (no caller in the reference
    passes one), so the CPU and the card take the same configurations;
    the sliding window (zamba2's) is the kernels' own mask and reaches
    them (tests/test_torch_flash_window.py holds it)."""
    q, k, v = _t(*_qkv(1, 8, 8, 2, 2, 16))
    np.testing.assert_array_equal(
        attention.flash_attention(q, k, v, window=4).numpy(),
        ops.flash_attention(q, k, v, kv_tile=KV, window=4).numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.flash_attention(q, k, v, q_offset=3)
    out = attention.flash_attention(q, k, v)
    np.testing.assert_array_equal(
        out.numpy(), ops.flash_attention(q, k, v, kv_tile=KV).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_never_falls_back(dtype):
    """The CUDA wrappers, forward and backward, refuse a CPU tensor of
    either dtype instead of running the plain version, and count
    nothing."""
    q, k, v = (x.to(dtype) for x in _t(*_qkv(1, 4, 4, 2, 2, 16)))
    before = dict(fa.LAUNCHES)
    assert set(before) == {"flash_attention_sm90", "flash_attention_f32",
                           "flash_attention_bwd_f32_sm90",
                           "flash_attention_bwd_sm90"}
    assert fa.BWD_KERNELS[dtype] in before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, kv_tile=KV)
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, v, q, lse, q)
    assert fa.LAUNCHES == before


def test_model_attention_matches_reference_chunked_attention():
    """The port's model attention against the reference's pure-JAX
    chunked attention (what the reference's models call), f32."""
    q, k, v = _qkv(2, 24, 24, 4, 2, 16, seed=6)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_chunk=8, kv_chunk=8))
    got = attention.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ------------------------------------------------------ decode attention
@pytest.mark.parametrize("mode", ["none", "valid_len", "kv_pos",
                                  "valid_len_window"])
def test_decode_attention_matches_reference(mode):
    """One new token against a cache, each mask mode, f32: both sides
    take the same products in f32 (1e-6: summation order)."""
    B, S, HQ, HK, D = 3, 12, 4, 2, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, 1, HQ, D), dtype=np.float32)
    kc = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    vc = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    nk = rng.standard_normal((B, 1, HK, D), dtype=np.float32)
    nv = rng.standard_normal((B, 1, HK, D), dtype=np.float32)
    kw = {}
    if mode.startswith("valid_len"):
        kw["valid_len"] = np.array([0, 5, 12], np.int32)
        if mode.endswith("window"):
            kw["window"] = 3
    elif mode == "kv_pos":
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        pos[0, 4:] = -1
        pos[1, ::3] = -1
        kw["kv_pos"] = pos
        kw["q_pos"] = np.array([4, 20, 12], np.int32)
    want = np.asarray(jattn.decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, nk, nv)),
        **{k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()}))
    got = attention.decode_attention(
        *_t(q, kc, vc, nk, nv),
        **{k: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# ------------------------------------------- the f32 kernel's 3xTF32 design
# csrc/flash_attention_f32_sm90.cu splits every operand x into TF32 hi =
# rna(x) and lo = rna(x - hi) and sums three TF32 products per 8-deep
# k-step, lo.hi, hi.lo, hi.hi, into f32 accumulators; P V takes the keys
# of each 8-key step in the order fa.TF32_KEY_ORDER.  The card alone runs
# the kernel; these tests hold an emulation of its arithmetic to the bar.
TF32_DROP = 13  # f32 mantissa bits below TF32's 10
# the kernel's keys per KV tile by head dim
F32_KV_TILE = {16: 64, 32: 64, 64: 64, 128: 32}


def _tf32_np(x):
    """cvt.rna.tf32.f32 in numpy: round the 13 dropped mantissa bits to
    nearest, ties away from zero (on the magnitude bits), keep f32's
    exponent range."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    half = np.uint32(1 << (TF32_DROP - 1))
    mask = np.uint32((0xFFFFFFFF << TF32_DROP) & 0xFFFFFFFF)
    return ((bits + half) & mask).view(np.float32)


def _split_np(x):
    x = np.asarray(x, dtype=np.float32)
    hi = _tf32_np(x)
    return hi, _tf32_np(x - hi)


def _tf32(x):
    """The same rounding on a torch f32 tensor (int32 bit arithmetic)."""
    b = x.contiguous().view(torch.int32)
    return ((b + (1 << (TF32_DROP - 1))) & -(1 << TF32_DROP)).view(
        torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_tf32(acc, a, b, terms):
    """acc + a @ b over the last / first-but-one axes, 8-deep k-steps in
    order; each step adds its products (exact in f32 for TF32 inputs,
    summed over the step in f64 and rounded once: the tensor core's own
    sum order is not IEEE) in the kernel's term order."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    pairs = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if terms == 3
             else [(a_hi, b_hi)])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            acc = acc + (x[..., k0:k0 + 8].double()
                         @ y[..., k0:k0 + 8, :].double()).float()
    return acc


LOG2E = np.float32(1.4426950408889634)


def _exp_kernel(x, m):
    """exp(x - m) as the kernel computes it: exp2f(fma(x, log2(e),
    -f32(m log2(e)))) (the f64 product of two f32 values is exact, so
    one f64 subtraction and the rounding to f32 stand in for the FMA)."""
    ml = (m * float(LOG2E)).double()
    return torch.exp2((x.double() * float(LOG2E) - ml).float())


def _emulate_f32_kernel(q, k, v, causal, terms=3,
                        key_order=fa.TF32_KEY_ORDER, permute_v=True):
    """The f32 kernel's function as it computes it: q scaled and rounded
    to f32, S = qs K^T and O += P V as TF32 products, online softmax over
    its KV tiles with its exp2 form in f32, keys permuted inside each 8-key
    step of P V (V's rows with P's columns unless ``permute_v`` is off)."""
    B, T, H, D = q.shape
    S, g = k.shape[1], H // k.shape[2]
    qs = (q * D ** -0.5).permute(0, 2, 1, 3)
    kh = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    m = torch.full((B, H, T, 1), ref.NEG_INF)
    l = torch.zeros((B, H, T, 1))
    o = torch.zeros((B, H, T, D))
    rows = torch.arange(T)[:, None]
    order = torch.tensor(key_order)
    bn = F32_KV_TILE[D]
    for k0 in range(0, S, bn):
        kt, vt = kh[:, :, k0:k0 + bn], vh[:, :, k0:k0 + bn]
        s = _mm_tf32(torch.zeros((B, H, T, kt.shape[2])), qs,
                     kt.transpose(-1, -2), terms)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(cols <= rows, s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = _exp_kernel(m, m_new)
        p = _exp_kernel(s, m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        # the kernel's zero-filled keys past S pad the tile to 8-key steps
        pad = -kt.shape[2] % 8
        p = torch.nn.functional.pad(p, (0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        n = p.shape[-1]
        perm = (torch.arange(0, n, 8)[:, None] + order[None, :]).reshape(-1)
        vt = vt[:, :, perm] if permute_v else vt
        o = _mm_tf32(o * corr, p[..., perm], vt, terms)
        m = m_new
    o = o / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3)


TIE = np.float32(1 + 2 ** -11)  # exactly half a TF32 ulp above 1
EDGE_VALUES = [
    (1.0, 1.0), (TIE, 1 + 2 ** -10), (-TIE, -(1 + 2 ** -10)),
    (np.nextafter(TIE, np.float32(0)), 1.0), (2.0 ** 20, 2.0 ** 20),
    (2.0 ** -126, 2.0 ** -126), (np.float32(2.0 - 2 ** -23), 2.0),
    (-1e30, None), (1e-40, None), (0.0, 0.0), (3.0e38, None),
]


@pytest.mark.parametrize("x,hi_want", EDGE_VALUES)
def test_tf32_split_edge_values(x, hi_want):
    """hi = rna(x) keeps 10 mantissa bits, ties away from zero; lo =
    rna(x - hi); both TF32 (the 13 low bits 0).  hi + lo is x within
    2^-22 relative; a denormal x within 2^-137 absolute (TF32 keeps f32's
    exponent range but only the 10 top mantissa bits of a denormal, so
    lo's own rounding sets the floor: half of 2^13 denormal steps)."""
    x = np.float32(x)
    hi, lo = _split_np(x)
    low = np.uint32((1 << TF32_DROP) - 1)
    assert (hi.view(np.uint32) & low) == 0 and (lo.view(np.uint32) & low) == 0
    if hi_want is not None:
        assert hi == np.float32(hi_want)
    err = abs(float(x) - (float(hi) + float(lo)))
    assert err <= max(2.0 ** -22 * abs(float(x)), 2.0 ** -137)


def test_tf32_split_torch_matches_numpy():
    """The torch split used by the emulation equals the numpy helper
    bitwise, on 2^16 standard-normal values, their scaled copies and the
    edge values."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal(1 << 16, dtype=np.float32)
    x = np.concatenate([x, x * np.float32(1e-3), x * np.float32(1e6),
                        np.array([e for e, _ in EDGE_VALUES], np.float32)])
    hi, lo = _split(torch.from_numpy(x))
    hi_np, lo_np = _split_np(x)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  hi_np.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  lo_np.view(np.uint32))


def test_tf32_key_order_matches_fragment_layouts():
    """TF32_KEY_ORDER follows from the two layouts.  In an 8-column group
    of the m64nN f32 accumulator, lane (g, c) = (lane / 4, lane % 4)
    holds d[4n + r] at (row g + 8 (r >> 1), column 2c + (r & 1)); the
    m64k8 TF32 A fragment's a_r is (row g + 8 (r & 1), column c + 4
    (r >> 1)).  The kernel feeds a0..a3 = d[4n], d[4n + 2], d[4n + 1],
    d[4n + 3]: the rows agree, and A column i takes key
    TF32_KEY_ORDER[i]."""
    feed = (0, 2, 1, 3)
    order = [None] * 8
    for c in range(4):
        for r in range(4):
            d = feed[r]
            assert 8 * (d >> 1) == 8 * (r & 1)  # same row, g or g + 8
            order[c + 4 * (r >> 1)] = 2 * c + (d & 1)
    assert tuple(order) == fa.TF32_KEY_ORDER
    assert sorted(order) == list(range(8))


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", PALLAS_CASES)
def test_3xtf32_emulation_meets_the_bar(B, T, S, H, HK, D, causal):
    """The f32 kernel's arithmetic (3xTF32, its term order, KV tiles and
    key permutation) lands within 2e-5 of the Pallas kernel in interpret
    mode and of ``flash_attention_ref``."""
    q, k, v = _qkv(B, T, S, H, HK, D, seed=17)
    got = _emulate_f32_kernel(*_t(q, k, v), causal).numpy()
    np.testing.assert_allclose(got, _pallas(q, k, v, causal), atol=ATOL,
                               rtol=0)
    want = ref.flash_attention_ref(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,T,S,H,HK,D,causal",
                         [c for c in PALLAS_CASES if c[5] == 64])
def test_one_tf32_product_misses_the_bar(B, T, S, H, HK, D, causal):
    """With one TF32 product (hi.hi) per step the same emulation is more
    than 2e-5 off at D = 64: the kernel needs all three."""
    q, k, v = _qkv(B, T, S, H, HK, D, seed=17)
    one = _emulate_f32_kernel(*_t(q, k, v), causal, terms=1).numpy()
    want = ref.flash_attention_ref(*_t(q, k, v), causal=causal).numpy()
    assert float(np.abs(one - want).max()) > ATOL


def test_key_permutation_must_reach_v():
    """P's columns and V^T's columns take the same key order: permuting
    P alone misses the bar by far, permuting both meets it."""
    q, k, v = _t(*_qkv(1, 64, 64, 2, 2, 32, seed=18))
    want = ref.flash_attention_ref(q, k, v).numpy()
    both = _emulate_f32_kernel(q, k, v, True).numpy()
    np.testing.assert_allclose(both, want, atol=ATOL, rtol=0)
    p_only = _emulate_f32_kernel(q, k, v, True, permute_v=False).numpy()
    assert float(np.abs(p_only - want).max()) > 100 * ATOL


@pytest.mark.parametrize("D", [32, 128])
def test_bf16_decode_scales_q_as_the_jax_model(D):
    """bf16 decode at the head dims whose D^-1/2 is not a bf16 value: the
    port's scaled q equals the JAX model's bitwise (bf16(D^-1/2), its
    weakly typed scalar), and ``decode_attention`` against
    ``repro.models.attention.decode_attention`` meets the bf16 bar with
    at least 99% of outputs equal (measured 100%; scaling by f32(D^-1/2)
    left 66-75% equal)."""
    B, S, HQ, HK = 2, 64, 8, 2
    rng = np.random.default_rng(21)
    shapes = [(B, 1, HQ, D), (B, S, HK, D), (B, S, HK, D), (B, 1, HK, D),
              (B, 1, HK, D)]
    ts, js = _bf16(*(rng.standard_normal(s, dtype=np.float32)
                     for s in shapes))
    want_q = np.array((js[0] * D ** -0.5).astype(jnp.float32))
    np.testing.assert_array_equal(ref.scale_q_bf16(ts[0]).float().numpy(),
                                  want_q)
    valid = np.array([40, 64], np.int32)
    want = _jax_f32(jattn.decode_attention(*js,
                                           valid_len=jnp.asarray(valid)))
    got = attention.decode_attention(*ts, valid_len=torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    _bf16_check(got, want, ts[2])
    assert float((got.float().numpy() == want).mean()) >= 0.99


def _jax_f32(x):
    return np.array(x.astype(jnp.float32))


def test_bf16_at_the_configs_kv_chunk():
    """The model's CPU path tiles bf16 P as the JAX model does, at the
    config's own ``kv_chunk``: at 1024 (the full configs' default) and
    T = 2048 the plain version against the jitted JAX attention meets both
    bf16 bars (measured 99.997% within one ulp + 2e-5, 0.12% of outputs
    not equal).  At the 128-key tile (the card's kernel's function before
    it took the chunk) it meets only the P bar and 90% within one ulp +
    2e-5 (here measured 93.1%, 27.5% not equal; that kernel against the
    plain version at 1024 on an H100, 92.97-95.76%): the chunk is part of
    the function, and every caller passes the model's."""
    (q, k, v), (jq, jk, jv) = _bf16(*_qkv(1, 2048, 2048, 4, 4, 64, seed=17))
    want = _jax_f32(jax.jit(lambda a, b, c: jattn.flash_attention(
        a, b, c, causal=True, q_chunk=1024, kv_chunk=1024))(jq, jk, jv))
    got = attention.flash_attention(q, k, v, causal=True, kv_chunk=1024)
    _bf16_check(got, want, v)
    kernel_tile = attention.flash_attention(q, k, v, causal=True,
                                            kv_chunk=TILE)
    _bf16_check(kernel_tile, want, v, share_bar=0.90)


# ------------------------------------------------------------- gradient
# The JAX package differentiates its pure-JAX chunked attention by
# autodiff; the port's gradient is ``ref.flash_attention_bwd_ref`` on the
# CPU (FlashAttention-2's formula from the forward's lse) and the CUDA
# kernels ``csrc/flash_attention_bwd_sm90.cu`` (bf16) and
# ``csrc/flash_attention_bwd_f32_sm90.cu`` (f32) on the card.
GRAD_CASES = [(1, 64, 64, 4, 2, 16, True), (2, 40, 72, 4, 4, 16, False),
              (1, 50, 30, 4, 1, 32, True)]
# f32 bar: 2e-5 max|g| (the forward's 2e-5 bar, scaled by the gradient)
GRAD_REL = 2e-5


def _mha_f64(q, k, v, causal):
    """Dense softmax attention in f64 with the Pallas kernel's top-left
    causal mask (autograd gives the exact gradient to compare with)."""
    T, S, D = q.shape[1], k.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    s = torch.einsum("bthd,bshd->bhts", q * D ** -0.5,
                     k.repeat_interleave(g, 2))
    if causal:
        s = s.masked_fill(torch.arange(S)[None, :] > torch.arange(T)[:, None],
                          -1e30)
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1),
                        v.repeat_interleave(g, 2))


def _grad_inputs(B, T, S, H, HK, D, seed=3):
    q, k, v = _qkv(B, T, S, H, HK, D, seed=seed)
    do = np.random.default_rng(seed + 1).standard_normal(
        (B, T, H, D), dtype=np.float32)
    return q, k, v, do


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", GRAD_CASES)
def test_plain_backward_matches_autograd_and_jax(B, T, S, H, HK, D, causal):
    """f32: ``flash_attention_bwd_ref`` from the plain forward's output
    and lse against autograd of dense attention in f64 and, where T == S
    and causal, against ``jax.grad`` of the JAX model's attention
    (``repro.models.attention.flash_attention``), within 2e-5 max|g|
    (measured 2e-7-1.4e-6)."""
    q, k, v, do = _grad_inputs(B, T, S, H, HK, D)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal, return_lse=True)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal,
                                      kv_tile=16)
    x64 = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    _mha_f64(*x64, causal).backward(torch.from_numpy(do).double())
    for g, x in zip(got, x64):
        assert g.dtype == torch.float32
        assert _max_rel(g.numpy(), x.grad.numpy()) <= GRAD_REL
    if causal and T == S:
        def fn(q, k, v):
            return jattn.flash_attention(q, k, v, causal=True, q_chunk=16,
                                         kv_chunk=16)

        _, pull = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        for g, w in zip(got, pull(jnp.asarray(do))):
            assert _max_rel(g.numpy(), w) <= GRAD_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_the_plain_backward(dtype):
    """``ops.flash_attention`` under autograd (``fa.FlashAttention`` on
    CPU tensors) gives the plain forward's output and exactly the plain
    backward's gradients; without a gradient it asks for no lse."""
    q, k, v, do = _grad_inputs(1, 48, 48, 4, 2, 32)
    tq, tk, tv, tdo = (t.to(dtype) for t in _t(q, k, v, do))
    xs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*xs, True, kv_tile=32)
    out.backward(tdo)
    plain = (ref.flash_attention_bf16_ref if dtype == torch.bfloat16
             else ref.flash_attention_ref)
    o_args = {"kv_tile": 32} if dtype == torch.bfloat16 else {}
    o, lse = plain(tq, tk, tv, True, **o_args, return_lse=True)
    assert torch.equal(out.detach(), o)
    for x, g in zip(xs, ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                                    True)):
        assert x.grad.dtype == dtype
        assert torch.equal(x.grad, g)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(tq, tk, tv, True,
                                               kv_tile=32), o)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("B,T,H,HK,D,chunk", [(1, 2048, 4, 4, 64, 1024),
                                              (1, 512, 8, 2, 128, 128)])
def test_bf16_gradient_error_at_most_twice_the_jax_models(B, T, H, HK, D,
                                                          chunk):
    """bf16, causal, at the configs' kv_chunk 1024 and at head_dim 128
    GQA: the port's gradient (plain forward at ``kv_chunk``, plain
    backward) and the JAX model's bf16 gradient (``jax.vjp`` of its
    attention, jitted), each against the JAX model's f32 gradient of the
    same bf16 values.  Bar: the port's relative L2 error is at most twice
    the JAX model's, per input.  Measured: port 1.8e-3 / 1.8e-3 / 2.3e-3
    against JAX 3.1e-3 / 3.4e-3 / 2.7e-3 (dq / dk / dv) at T = 2048, and
    2.4e-3 / 2.9e-3 / 2.7e-3 against 3.9e-3 / 4.2e-3 / 3.1e-3 at D = 128."""
    q, k, v, do = _grad_inputs(B, T, T, H, HK, D, seed=0)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    f = [t.float().numpy() for t in tb]

    def jax_grad(dt):
        def fn(q, k, v):
            return jattn.flash_attention(q, k, v, causal=True,
                                         q_chunk=chunk, kv_chunk=chunk)

        def vjp(q, k, v, do):
            return jax.vjp(fn, q, k, v)[1](do)

        out = jax.jit(vjp)(*(jnp.asarray(a).astype(dt) for a in f))
        return [np.asarray(x.astype(jnp.float32)) for x in out]

    g32, gbf = jax_grad(jnp.float32), jax_grad(jnp.bfloat16)
    xs = [t.clone().requires_grad_() for t in tb[:3]]
    attention.flash_attention(*xs, causal=True, kv_chunk=chunk).backward(
        tb[3])
    for x, jbf, j32 in zip(xs, gbf, g32):
        assert x.grad.dtype == torch.bfloat16
        port = _rel_l2(x.grad.float().numpy(), j32)
        assert port <= 2 * _rel_l2(jbf, j32), (port, _rel_l2(jbf, j32))


# The bf16 backward kernel (csrc/flash_attention_bwd_sm90.cu) computes on
# bf16 tensor cores with f32 sums: S, dP, P and dS in f32, dV from bf16(P),
# dK and dQ from dS as a bf16 hi + lo pair (each half's product exact in
# f32).  Its query tile in dK / dV (BQ) and its key tile in dQ (BK, by
# head dim) set where the f32 sums round between tiles; dK and dV add each
# tile's sum to one running sum over the query heads of their KV head, in
# order.
BWD_BQ = 64
BWD_BK = {16: 128, 32: 128, 64: 128, 128: 64}
BWD_EMU_CASES = [(2, 64, 192, 4, 4, 16, False), (2, 300, 130, 8, 2, 64, True),
                 (1, 130, 300, 4, 1, 32, True), (1, 256, 256, 4, 4, 64, True),
                 (1, 256, 256, 8, 2, 128, True)]


def _tile_mm(pairs, tile):
    """sum over ``pairs`` of a @ b, contracting the last axis of a with the
    first-but-one of b in tiles of ``tile``: each tile's products summed in
    f64 and rounded once (the tensor core's sum inside a step is not
    IEEE), the tiles added in f32 in order."""
    acc = None
    for t0 in range(0, pairs[0][0].shape[-1], tile):
        part = sum(a[..., t0:t0 + tile].double()
                   @ b[..., t0:t0 + tile, :].double() for a, b in pairs)
        acc = part.float() if acc is None else acc + part.float()
    return acc


def _head_tile_mm(pairs, tile, g):
    """dK / dV's sums: ``_tile_mm`` of (B, H, S, T) by (B, H, T, D) pairs
    over the query tiles of each KV head's ``g`` query heads, heads in
    order, in one running f32 sum -> (B, H / g, S, D).  A tile holds one
    head's queries (T padded to the tile with zeros)."""
    T = pairs[0][0].shape[-1]
    pad = -T % tile

    def heads_in_k(a, b):
        B, H, S, D = a.shape[0], a.shape[1], a.shape[2], b.shape[-1]
        a = torch.nn.functional.pad(a, (0, pad)).reshape(B, H // g, g, S,
                                                         T + pad)
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        return (a.permute(0, 1, 3, 2, 4).reshape(B, H // g, S, -1),
                b.reshape(B, H // g, -1, D))

    return _tile_mm([heads_in_k(a, b) for a, b in pairs], tile)


def _emulate_bf16_bwd(q, k, v, o, lse, do, causal, split=True):
    """The bf16 backward kernel's arithmetic in plain PyTorch: (dq, dk, dv)
    in bf16.  P = exp2(S log2(e) - f32(lse log2(e))) as the kernel forms
    it; without ``split`` dS enters dK and dQ as one bf16 value."""
    B, T, H, D = q.shape
    S, HK = k.shape[1], k.shape[2]
    g = H // HK
    qs = ref.scale_q_bf16(q).float().permute(0, 2, 1, 3)
    do32 = do.float().permute(0, 2, 1, 3)
    kh = k.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    vh = v.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    drow = (do32.double() * o.double().permute(0, 2, 1, 3)).sum(
        -1, keepdim=True).float()
    s = (qs.double() @ kh.double().transpose(-1, -2)).float()
    dp = (do32.double() @ vh.double().transpose(-1, -2)).float()
    p = _exp_kernel(s, lse[..., None])
    if causal:
        p = torch.where(torch.arange(S)[None, :] <= torch.arange(T)[:, None],
                        p, 0.0)
    ds = p * (dp - drow)
    hi = ds.to(torch.bfloat16).float()
    lo = (ds - hi).to(torch.bfloat16).float() if split else 0 * hi
    pt = p.to(torch.bfloat16).float().transpose(-1, -2)
    dv = _head_tile_mm([(pt, do32)], BWD_BQ, g)
    dk = _head_tile_mm([(hi.transpose(-1, -2), qs),
                        (lo.transpose(-1, -2), qs)], BWD_BQ, g)
    dq = _tile_mm([(hi, kh), (lo, kh)], BWD_BK[D]) * ref.bf16_scale(D)
    return tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for x in (dq, dk, dv))


def _bf16_bwd_inputs(B, T, S, H, HK, D, causal):
    """bf16 q, k, v, dO, the plain forward's output and lse at the
    configs' kv_chunk, as the train path calls the kernels."""
    q, k, v, do = (t.to(torch.bfloat16)
                   for t in _t(*_grad_inputs(B, T, S, H, HK, D, seed=5)))
    o, lse = ref.flash_attention_bf16_ref(q, k, v, causal, kv_tile=KV,
                                          return_lse=True)
    return q, k, v, o, lse, do


def _bwd_bars(got, want, q, k, lse, do, causal):
    """chip_smoke.py's bf16 backward bars: per output, the count over one
    ulp + 2e-5 max|g| (dV also + 2^-9 max|dO| max_j sum_i P[i, j], for
    the bf16 rounding of P) and the share within one ulp + 2e-5 max|g|."""
    g = q.shape[2] // k.shape[2]
    qs = ref.scale_q_bf16(q).float().permute(0, 2, 1, 3)
    kh = k.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    p = torch.exp(qs @ kh.transpose(-1, -2) - lse[..., None])
    if causal:
        T, S = q.shape[1], k.shape[1]
        p = torch.where(torch.arange(S)[None, :] <= torch.arange(T)[:, None],
                        p, 0.0)
    colsum = float(p.sum(2).max())
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - b.float()).abs()
        gmax = float(b.float().abs().max())
        ulp = _bf16_ulp(b)
        slack = GRAD_REL * gmax
        if name == "dv":
            slack += BF16_P_BAR * float(do.float().abs().max()) * colsum
        out[name] = (int((diff > ulp + slack).sum()),
                     float((diff <= ulp + GRAD_REL * gmax).float().mean()))
    return out


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", BWD_EMU_CASES)
def test_bf16_backward_emulation_meets_the_bar(B, T, S, H, HK, D, causal):
    """The bf16 backward kernel's arithmetic (dS as a bf16 hi + lo pair)
    meets chip_smoke.py's bars against ``flash_attention_bwd_ref`` at D
    16 / 32 / 64 / 128, GQA, ragged and non-causal: every output within
    one ulp + 2e-5 max|g| (dV + the bf16-P slack), at least 99% within
    one ulp + 2e-5 max|g| (measured 99.99-100%)."""
    args = _bf16_bwd_inputs(B, T, S, H, HK, D, causal)
    got = _emulate_bf16_bwd(*args, causal)
    want = ref.flash_attention_bwd_ref(*args, causal)
    q, k, _, _, lse, do = args
    bars = _bwd_bars(got, want, q, k, lse, do, causal)
    for name, (over, share) in bars.items():
        assert over == 0, (name, bars)
        assert share >= BF16_SHARE, (name, bars)


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", BWD_EMU_CASES)
def test_one_bf16_ds_misses_the_bar(B, T, S, H, HK, D, causal):
    """With dS rounded once to bf16 (FlashAttention-2's and -3's choice)
    the same emulation misses both bars in dQ and dK (measured 87-96%
    within one ulp + 2e-5 max|g|): the kernel needs the lo term."""
    args = _bf16_bwd_inputs(B, T, S, H, HK, D, causal)
    got = _emulate_bf16_bwd(*args, causal, split=False)
    want = ref.flash_attention_bwd_ref(*args, causal)
    q, k, _, _, lse, do = args
    bars = _bwd_bars(got, want, q, k, lse, do, causal)
    for name in ("dq", "dk"):
        over, share = bars[name]
        assert over > 0 and share < BF16_SHARE, (name, bars)


# The f32 backward kernel (csrc/flash_attention_bwd_f32_sm90.cu) computes
# every product as three TF32 products per 8-deep k-step (lo.hi, hi.lo,
# hi.hi).  S and dP sum over D in one f32 accumulator; dQ, dK and dV sum
# each tile of keys (dQ: F32_BWD_BK by head dim) or queries (dK, dV:
# F32_BWD_BQ), the kernel's own (fa.F32_BWD_TILES, which chip_smoke.py holds
# against the library's on the card), in a fresh accumulator and add it to the running sum in f32
# (the tensor core does not round its adds to nearest: on the card, one
# running wgmma accumulator over a thousand queries drifted past the bar).
# The products that contract over queries (dV, dK) or keys (dQ) take the
# accumulator (P^T, dS^T, dS) as the TF32 A fragment, whose column i is
# the accumulator's column TF32_KEY_ORDER[i] in each 8-step, and the
# transposed operand (dO^T, qs^T, k^T, written by the preprocess) in the
# order ``order``.
F32_BWD_BK = {d: bk for d, (bk, _) in fa.F32_BWD_TILES.items()}
F32_BWD_BQ = {d: bq for d, (_, bq) in fa.F32_BWD_TILES.items()}
F32_BWD_CASES = BWD_EMU_CASES + [(1, 96, 80, 4, 2, 32, False),
                                 (1, 130, 200, 4, 1, 128, False)]


def _perm8(x, dim, order):
    """x zero-padded along ``dim`` to a multiple of 8, each 8-group
    reordered: position i holds element ``order[i]``."""
    pad = -x.shape[dim] % 8
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    n = x.shape[dim]
    perm = (torch.arange(0, n, 8)[:, None]
            + torch.tensor(order)[None, :]).reshape(-1)
    return x.index_select(dim, perm)


def _emulate_f32_bwd(q, k, v, o, lse, do, causal, terms=3,
                     order=fa.TF32_KEY_ORDER):
    """The f32 backward kernel's arithmetic in plain PyTorch: (dq, dk, dv).
    S = qs k^T and dP = dO v^T as TF32 products over D; P = exp2(S log2(e)
    - f32(lse log2(e))) as the kernel forms it, masked; Drow = rowsum(P
    dP); dS = P (dP - Drow) in f32; dV = P^T dO, dK = dS^T qs (summed over the query heads of each
    KV head in order) and dQ = scale dS k as TF32 products over queries or
    keys, tile by tile, A's columns in TF32_KEY_ORDER and the transposed
    operand's rows in ``order``.  ``terms`` = 1 keeps only hi.hi."""
    B, T, H, D = q.shape
    S, HK = k.shape[1], k.shape[2]
    g = H // HK
    qs = (q * D ** -0.5).permute(0, 2, 1, 3)
    do32 = do.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(g, 2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(g, 2).permute(0, 2, 1, 3)
    s = _mm_tf32(torch.zeros((B, H, T, S)), qs, kh.transpose(-1, -2), terms)
    dp = _mm_tf32(torch.zeros((B, H, T, S)), do32, vh.transpose(-1, -2),
                  terms)
    p = _exp_kernel(s, lse[..., None])
    if causal:
        p = torch.where(torch.arange(S)[None, :] <= torch.arange(T)[:, None],
                        p, 0.0)
    # Drow from the kernel's own P and dP (its row-sum pass), not from o
    drow = (p.double() * dp.double()).sum(-1, keepdim=True).float()
    ds = p * (dp - drow)
    hw = fa.TF32_KEY_ORDER

    def tiled(acc, a, b, tile):
        for t0 in range(0, a.shape[-1], tile):
            acc = acc + _mm_tf32(torch.zeros_like(acc), a[..., t0:t0 + tile],
                                 b[..., t0:t0 + tile, :], terms)
        return acc

    dq = tiled(torch.zeros((B, H, T, D)), _perm8(ds, -1, hw),
               _perm8(kh, -2, order), F32_BWD_BK[D]) * np.float32(D ** -0.5)
    pt, dst = _perm8(p.transpose(-1, -2), -1, hw), _perm8(
        ds.transpose(-1, -2), -1, hw)
    dot, qst = _perm8(do32, -2, order), _perm8(qs, -2, order)
    dk = torch.zeros((B, HK, S, D))
    dv = torch.zeros((B, HK, S, D))
    for i in range(g):
        heads = torch.arange(HK) * g + i
        dv = tiled(dv, pt[:, heads], dot[:, heads], F32_BWD_BQ[D])
        dk = tiled(dk, dst[:, heads], qst[:, heads], F32_BWD_BQ[D])
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _f32_bwd_inputs(B, T, S, H, HK, D, causal):
    """f32 q, k, v, dO, the plain forward's output and lse."""
    q, k, v, do = _t(*_grad_inputs(B, T, S, H, HK, D, seed=7))
    o, lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
    return q, k, v, o, lse, do


def _f32_bwd_rel(got, want):
    """max |got - want| / max |want| for dq, dk, dv."""
    return [_max_rel(a.numpy(), b.numpy()) for a, b in zip(got, want)]


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", F32_BWD_CASES)
def test_f32_backward_emulation_meets_the_bar(B, T, S, H, HK, D, causal):
    """The f32 backward kernel's arithmetic (3xTF32, its term order and
    its TF32_KEY_ORDER for the transposed operands) lands within 2e-5
    max|g| of ``flash_attention_bwd_ref`` at D 16 / 32 / 64 / 128, GQA,
    ragged and non-causal (chip_smoke.py's bar for the kernel; measured
    1.4e-7-1.0e-6)."""
    args = _f32_bwd_inputs(B, T, S, H, HK, D, causal)
    rel = _f32_bwd_rel(_emulate_f32_bwd(*args, causal),
                       ref.flash_attention_bwd_ref(*args, causal))
    assert max(rel) <= GRAD_REL, rel


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", F32_BWD_CASES)
def test_one_tf32_product_misses_the_backward_bar(B, T, S, H, HK, D,
                                                  causal):
    """With one TF32 product (hi.hi) per step the same emulation is more
    than 2e-5 max|g| off (measured 3.4e-4-1.2e-3): the kernel needs all
    three."""
    args = _f32_bwd_inputs(B, T, S, H, HK, D, causal)
    rel = _f32_bwd_rel(_emulate_f32_bwd(*args, causal, terms=1),
                       ref.flash_attention_bwd_ref(*args, causal))
    assert max(rel) > GRAD_REL, rel


def test_backward_transposes_take_the_fragment_order():
    """The transposed operands (dO^T, qs^T, k^T) written in identity order
    instead of TF32_KEY_ORDER pair each A column with another row of B:
    every output misses the bar by far (measured 0.54-1.75 max|g|); in
    TF32_KEY_ORDER all meet it."""
    args = _f32_bwd_inputs(1, 64, 64, 2, 2, 32, True)
    want = ref.flash_attention_bwd_ref(*args, True)
    good = _f32_bwd_rel(_emulate_f32_bwd(*args, True), want)
    assert max(good) <= GRAD_REL, good
    bad = _f32_bwd_rel(_emulate_f32_bwd(*args, True, order=tuple(range(8))),
                       want)
    assert min(bad) > 100 * GRAD_REL, bad


@pytest.mark.parametrize("kv_tile,S,want", [(256, 300, 2), (128, 300, 1),
                                            (1024, 2048, 8), (1000, 300, 3),
                                            (300, 300, 3)])
def test_bf16_kernel_span_in_tiles(kv_tile, S, want):
    """The bf16 kernel's span: whole 128-key tiles (one tile is the
    single pass), or one span over every key when the chunk covers S."""
    assert fa.span_tiles(kv_tile, S) == want


def test_bf16_kernel_span_refuses_partial_tiles():
    """A chunk that is neither a multiple of 128 keys nor at least S
    (the smoke configs' 8) raises on the card's path, naming the rule;
    the plain version takes it."""
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.span_tiles(8, 300)
    q, k, v = (t.bfloat16() for t in _t(*_qkv(1, 20, 20, 2, 2, 16)))
    assert ops.flash_attention(q, k, v, True, kv_tile=8).shape == q.shape
