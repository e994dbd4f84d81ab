"""The port's attention against the JAX package: the plain flash
attention (the CPU path of ``ops.flash_attention``, and the yardstick of
the CUDA kernel on the card) against the Pallas kernel in interpret mode
and against ``mha_ref``; ``decode_attention`` in its three mask modes;
and the shapes and masks the port refuses.  Inputs are made with numpy
from a seed and handed to both."""
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


def _qkv(B, T, S, H, HK, D, seed=11):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    v = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# test_kernels.py's four shapes, two more GQA cases at D = 128 and a
# ragged causal case with T != S (the Pallas mask, aligned top left)
PALLAS_CASES = [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 2, 2, 32, True),
    (2, 64, 192, 4, 4, 16, False),
    (1, 96, 96, 2, 1, 128, True),
    (2, 80, 80, 8, 2, 128, True),
    (1, 64, 64, 4, 1, 128, False),
    (1, 48, 100, 2, 2, 32, True),
]


@pytest.mark.parametrize("B,T,S,H,HK,D,causal", PALLAS_CASES)
def test_plain_matches_pallas_kernel(B, T, S, H, HK, D, causal):
    """The port's flash attention on the CPU equals the Pallas kernel
    (interpret mode, through the reference's ops wrapper: GQA repeat and
    padding to 64-blocks) within 2e-5."""
    q, k, v = _qkv(B, T, S, H, HK, D)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=64, bk=64, interpret=True))
    got = ops.flash_attention(*_t(q, k, v), causal=causal)
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
    full = ops.flash_attention(*_t(q, k, v))
    head = ops.flash_attention(*_t(q, k[:, :8], v[:, :8]))
    np.testing.assert_allclose(full.numpy(), head.numpy(), atol=1e-6,
                               rtol=0)


def test_bf16_in_bf16_out():
    """bf16 inputs give a bf16 output within one bf16 rounding (plus the
    f32 bar) of the f32 computation on the same (bf16-exact) inputs."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 40, 40, 4, 2, 64, seed=5))
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    f32 = ops.flash_attention(q.float(), k.float(), v.float())
    ulp = torch.finfo(torch.bfloat16).eps * f32.abs()
    assert bool(((out.float() - f32).abs() <= ulp + ATOL).all())


@pytest.mark.parametrize("D", [8, 48, 256])
def test_unsupported_head_dim_raises(D):
    q, k, v = _t(*_qkv(1, 4, 4, 2, 2, D))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)


def test_unsupported_shapes_and_types_raise():
    q, k, v = _t(*_qkv(1, 4, 4, 3, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(1, 4, 4, 2, 2, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, k, v[:, :3])


def test_model_attention_refuses_other_masks():
    """A window or a query offset raises on every device (zamba2's window
    comes with its slice), so the CPU and the card take the same
    configurations."""
    q, k, v = _t(*_qkv(1, 8, 8, 2, 2, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.flash_attention(q, k, v, window=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.flash_attention(q, k, v, q_offset=3)
    out = attention.flash_attention(q, k, v)
    np.testing.assert_array_equal(out.numpy(),
                                  ops.flash_attention(q, k, v).numpy())


def test_kernel_wrapper_never_falls_back():
    """The CUDA wrapper refuses a CPU tensor instead of running the plain
    version, and counts nothing."""
    q, k, v = _t(*_qkv(1, 4, 4, 2, 2, 16))
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
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
