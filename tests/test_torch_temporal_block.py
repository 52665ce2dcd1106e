"""The fused-block kernels' plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode on the CPU), on identical seeded inputs.

Tolerance: float32, atol 5e-5 — the Pallas tests' own 2e-5 plus slack for a
different summation order (torch vs XLA matmuls) over up to 3*64 products."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videopose3d_tpu.ops.pallas import temporal_block as jtb
from videopose3d_torch.ops.kernels import temporal_block as ttb

ATOL = 5e-5


def _bn(rng, c):
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32)},
            {"mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)})


def _block_inputs(rng, c, k=3):
    w1 = (rng.standard_normal((k, c, c)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((1, c, c)) * 0.05).astype(np.float32)
    return w1, w2, _bn(rng, c), _bn(rng, c)


def _fold_both(bn):
    """The folded affine from the JAX helper, as numpy."""
    s, b = jtb.fold_batchnorm(*bn)
    return np.asarray(s), np.asarray(b)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(0)
    p, s = _bn(rng, 48)
    want = _fold_both((p, s))
    got = ttb.fold_batchnorm(_t(p["scale"]), _t(p["bias"]), _t(s["mean"]),
                             _t(s["var"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("c,dilation,t,t_tile,causal_shift", [
    (32, 1, 40, 16, 0),
    (64, 3, 70, 16, 0),
    (32, 3, 70, 16, 3),     # causal
    (64, 9, 100, 32, 0),
    (32, 1, 19, 16, 0),     # ragged tail (t_out=17 not divisible by 16)
    (32, 3, 300, 256, 0),   # single tile larger than t_out
])
def test_dilated_block_plain_matches_pallas(c, dilation, t, t_tile, causal_shift):
    rng = np.random.default_rng(c + dilation + t)
    w1, w2, bn1, bn2 = _block_inputs(rng, c)
    x = (rng.standard_normal((2, t, c)) * 0.5).astype(np.float32)
    s1, b1 = _fold_both(bn1)
    s2, b2 = _fold_both(bn2)
    want = np.asarray(jtb.fused_dilated_block(
        jnp.asarray(x), jnp.asarray(w1), s1, b1, jnp.asarray(w2), s2, b2,
        dilation=dilation, causal_shift=causal_shift, t_tile=t_tile,
        interpret=True))
    got = ttb.fused_dilated_block(
        _t(x), _t(w1), _t(s1), _t(b1), _t(w2), _t(s2), _t(b2),
        dilation=dilation, causal_shift=causal_shift)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("c,dilation,t,causal_shift", [
    (32, 3, 40, 0),
    (64, 3, 45, 3),     # causal
    (32, 5, 60, 0),
])
def test_expand_block_plain_matches_pallas(c, dilation, t, causal_shift):
    rng = np.random.default_rng(7 + c + t)
    w0 = (rng.standard_normal((3, 34, c)) * 0.1).astype(np.float32)
    bn0 = _bn(rng, c)
    w1, w2, bn1, bn2 = _block_inputs(rng, c)
    x = rng.uniform(-1, 1, (2, t, 34)).astype(np.float32)
    s0, b0 = _fold_both(bn0)
    s1, b1 = _fold_both(bn1)
    s2, b2 = _fold_both(bn2)
    want = np.asarray(jtb.fused_expand_block(
        jnp.asarray(x), jnp.asarray(w0), s0, b0, jnp.asarray(w1), s1, b1,
        jnp.asarray(w2), s2, b2, dilation=dilation, causal_shift=causal_shift,
        t_tile=16, interpret=True))
    got = ttb.fused_expand_block(
        _t(x), _t(w0), _t(s0), _t(b0), _t(w1), _t(s1), _t(b1), _t(w2), _t(s2),
        _t(b2), dilation=dilation, causal_shift=causal_shift)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("c,dilation,t,causal_shift", [
    (32, 9, 50, 0),
    (64, 3, 23, 3),     # causal, ragged
])
def test_shrink_block_plain_matches_pallas(c, dilation, t, causal_shift):
    rng = np.random.default_rng(11 + c + t)
    w1, w2, bn1, bn2 = _block_inputs(rng, c)
    ws = (rng.standard_normal((1, c, 51)) * 0.1).astype(np.float32)
    bs = rng.uniform(-0.1, 0.1, 51).astype(np.float32)
    x = (rng.standard_normal((2, t, c)) * 0.5).astype(np.float32)
    s1, b1 = _fold_both(bn1)
    s2, b2 = _fold_both(bn2)
    want = np.asarray(jtb.fused_shrink_block(
        jnp.asarray(x), jnp.asarray(w1), s1, b1, jnp.asarray(w2), s2, b2,
        jnp.asarray(ws), jnp.asarray(bs), dilation=dilation,
        causal_shift=causal_shift, t_tile=16, interpret=True))
    got = ttb.fused_shrink_block(
        _t(x), _t(w1), _t(s1), _t(b1), _t(w2), _t(s2), _t(b2), _t(ws), _t(bs),
        dilation=dilation, causal_shift=causal_shift)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_bf16_cast_points_match_pallas():
    """bfloat16 in the same places as the TPU kernel: with identical bf16
    inputs the results agree to one bf16 step of the output scale."""
    rng = np.random.default_rng(3)
    c = 32
    w1, w2, bn1, bn2 = _block_inputs(rng, c)
    x = (rng.standard_normal((2, 40, c)) * 0.5).astype(np.float32)
    s1, b1 = _fold_both(bn1)
    s2, b2 = _fold_both(bn2)
    want = np.asarray(jtb.fused_dilated_block(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16), s1, b1,
        jnp.asarray(w2, jnp.bfloat16), s2, b2, dilation=3, t_tile=16,
        interpret=True)).astype(np.float32)
    got = ttb.fused_dilated_block(
        _t(x).bfloat16(), _t(w1).bfloat16(), _t(s1), _t(b1), _t(w2).bfloat16(),
        _t(s2), _t(b2), dilation=3)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 ** -8 * np.abs(want).max())


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel's checks, which
    refuse anything but CUDA: no silent fallback to the plain version."""
    rng = np.random.default_rng(0)
    w1, w2, bn1, bn2 = _block_inputs(rng, 8)
    s1, b1 = _fold_both(bn1)
    s2, b2 = _fold_both(bn2)
    meta = lambda a: _t(a).to("meta")
    before = dict(ttb.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ttb.fused_dilated_block(meta(np.zeros((1, 10, 8), np.float32)), meta(w1),
                                meta(s1), meta(b1), meta(w2), meta(s2), meta(b2),
                                dilation=1)
    assert ttb.LAUNCHES == before


@pytest.mark.parametrize("c,limit", [(1024, None), (1496, None), (1030, "multiple of 4"),
                                     (1500, "expand kernel"), (3636, "dilated kernel")])
def test_channel_limit_error_names_the_limit(c, limit):
    """The fused evaluation kernels' width limits at -arc 3,3,3,3,3 (17 x 2
    keypoint columns, an expand block of 3 taps, a first block reaching 6 frames),
    known without the card from the kernels' shared-memory formulas."""
    err = ttb.channel_limit_error(c, c_in=34, k0=3, span=6)
    if limit is None:
        assert err is None
        assert ttb.block_smem_bytes("expand", c, 34, 3, 6) <= ttb.SMEM_OPT_IN
    else:
        assert limit in err and "--serving-engine xla" in err
    assert (ttb.channel_limit_error(c) is None) == (c % 4 == 0 and 32 * 4 * c <= 232_448)
