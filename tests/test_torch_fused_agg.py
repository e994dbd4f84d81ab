"""The port's fused codec (``repro_torch.kernels.ops``) against the JAX
package's, on the CPU, where the port runs the kernels' plain versions.
The CUDA kernels themselves are held to those plain versions on the card
by chip_smoke.py.

Inputs are made with numpy from a seed and handed to both packages.
Packed words must be bitwise equal to the reference's Pallas kernel
(interpret mode) and to its XLA oracle, for scalar and per-coordinate
steps alike."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fused_agg, ops, ref

# the reference's own tolerance for the fused decode (test_kernels.py)
DECODE_ATOL = 1e-6

SWEEP = [(4, 3), (8, 25), (16, 4000), (24, 80000)]


def _inputs(bits, m_max, percoord, shape=(1000, 37)):
    rng = np.random.default_rng(bits * 2 + percoord)
    x = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    s = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    base = 1.0 / (m_max - 1)
    step = ((base * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
            if percoord else base)
    return x, s, step


def _t(a):
    return a if isinstance(a, float) else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bits,m_max", SWEEP)
@pytest.mark.parametrize("percoord", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encode_words_bitwise(bits, m_max, percoord, impl):
    """Words bitwise equal.  A scalar step is a compile-time constant in
    the reference, which XLA divides by as fma(x, f32(1 / step), s): the
    port (and its CUDA kernel) compute just that; a per-coordinate step
    divides exactly on both sides."""
    x, s, step = _inputs(bits, m_max, percoord)
    w_ref = np.asarray(jops.fused_pack_encode(
        jnp.asarray(x), jnp.asarray(s),
        jnp.asarray(step) if percoord else step, bits, m_max, impl=impl))
    w = ops.fused_pack_encode(_t(x), _t(s), _t(step), bits, m_max)
    assert w.dtype == torch.int32 and tuple(w.shape) == w_ref.shape
    assert np.array_equal(w.numpy(), w_ref)


@pytest.mark.parametrize("bits,m_max", SWEEP)
@pytest.mark.parametrize("percoord", [False, True])
@pytest.mark.parametrize("with_offset", [False, True])
def test_decode_matches_reference(bits, m_max, percoord, with_offset):
    shape = (1000, 37)
    x, s, step = _inputs(bits, m_max, percoord, shape)
    words = np.asarray(jops.fused_pack_encode(
        jnp.asarray(x), jnp.asarray(s),
        jnp.asarray(step) if percoord else step, bits, m_max, impl="xla"))
    s_eff = s + np.float32(m_max)  # one message summed: r = 1
    offset = (np.random.default_rng(1).uniform(0, 0.25, shape)
              .astype(np.float32) if with_offset else None)
    y_ref = np.asarray(jops.fused_unpack_decode(
        jnp.asarray(words), jnp.asarray(s_eff),
        jnp.asarray(step) if percoord else step,
        None if offset is None else jnp.asarray(offset), bits, shape,
        impl="xla"))
    y = ops.fused_unpack_decode(
        torch.from_numpy(words.copy()), _t(s_eff), _t(step),
        None if offset is None else _t(offset), bits, shape)
    assert tuple(y.shape) == shape
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=DECODE_ATOL)


def test_pad_rows_layout():
    """Flat -> (R, g, 128); steps pad with 1.0, everything else with 0."""
    x = torch.arange(1, 301, dtype=torch.float32)
    r = ops._pad_rows(x, 2)
    assert tuple(r.shape) == (2, 2, 128)
    assert torch.equal(r.reshape(-1)[:300], x)
    assert bool((r.reshape(-1)[300:] == 0).all())
    assert bool((ops._pad_rows(x, 2, 1.0).reshape(-1)[300:] == 1).all())
    ref_r = np.asarray(jops._pad_rows(jnp.asarray(x.numpy()), 2))
    assert np.array_equal(ref_r, r.numpy())


def test_top_field_touching_bit_31_is_recovered():
    """A summed 16-bit top field >= 2^15 sets the sign bit of the word;
    the unsigned unpack still recovers it exactly."""
    u = torch.tensor([[40000, 65535]], dtype=torch.int32)  # (1, G=2) fields
    word = (u[:, 0] | (u[:, 1] << 16)).reshape(1, 1).expand(1, 128)
    out = ref.unpack_biased_ref(word.contiguous(), 16)
    assert out.shape == (1, 2, 128)
    assert int(out[0, 0, 0]) == 40000 and int(out[0, 1, 0]) == 65535


@pytest.mark.parametrize("bits", [1, 25, 32])
def test_field_cap_raises(bits):
    x = torch.zeros(256)
    with pytest.raises(ValueError):
        ops.fused_pack_encode(x, x, 0.1, bits, 3)
    with pytest.raises(ValueError):
        ops.fused_unpack_decode(torch.zeros((1, 128), dtype=torch.int32), x,
                                0.1, None, bits, x.shape)


def test_shape_errors_raise():
    x = torch.zeros(300)
    with pytest.raises(ValueError):
        ops.fused_pack_encode(x, torch.zeros(299), 0.1, 8, 25)
    with pytest.raises(ValueError):  # 300 coords at b=8 need one row
        ops.fused_unpack_decode(torch.zeros((2, 128), dtype=torch.int32),
                                x, 0.1, None, 8, x.shape)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA only; a CPU tensor never
    reaches them through ops and raises if handed to them directly."""
    x = torch.zeros((1, 4, 128))
    with pytest.raises(ValueError):
        fused_agg.fused_encode(x, x, 0.1, 8, 25)
    with pytest.raises(ValueError):
        fused_agg.fused_decode(torch.zeros((1, 128), dtype=torch.int32), x,
                               0.1, None, 8)
    assert fused_agg.LAUNCHES == {"fused_encode": 0, "fused_decode": 0}
