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
from videopose3d_torch.ops.kernels import train_block as trb

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


@pytest.mark.parametrize("c,limit", [(1024, None), (1496, None), (1030, None),
                                     (1500, None), (3636, None)])
def test_channel_limit_error_names_the_limit(c, limit):
    """The fused evaluation kernels take any width, as the JAX package's:
    nothing is held per channel in shared memory, and the fused forward pads
    widths that are not whole 16-byte words."""
    assert ttb.channel_limit_error(c) is limit
    assert "at least one channel" in ttb.channel_limit_error(0)


@pytest.mark.parametrize("dt,c,c_pad", [("float32", 30, 32), ("bfloat16", 30, 32),
                                        ("float32", 36, 36), ("bfloat16", 36, 40)])
def test_padded_widths_match_pallas(dt, c, c_pad):
    """At a width that is not a whole 16-byte word of the dtype, the fused forward
    pads the operands with zeros (``pad``, ``padded_block``): the channels, the
    expand block's 34 keypoint columns (to 36 in float32, 40 in bf16) and the
    shrink's 51 outputs (52, 56).  The three blocks on the padded operands, cut
    back to C (51), agree with the JAX package's on the unpadded ones (bf16: one
    bf16 step of the output scale), and the padded channels come out exactly 0."""
    tdt = getattr(torch, dt)
    assert ttb.whole_words(c, tdt) == c_pad
    ci, j3 = ttb.whole_words(34, tdt), ttb.whole_words(51, tdt)
    assert (ci, j3) == ((36, 52) if dt == "float32" else (40, 56))
    rng = np.random.default_rng(c + len(dt))
    jdt = getattr(jnp, dt)
    w0 = (rng.standard_normal((3, 34, c)) * 0.1).astype(np.float32)
    s0, b0 = _fold_both(_bn(rng, c))
    w1, w2, bn1, bn2 = _block_inputs(rng, c)
    s1, b1 = _fold_both(bn1)
    s2, b2 = _fold_both(bn2)
    ws = (rng.standard_normal((1, c, 51)) * 0.1).astype(np.float32)
    bs = rng.uniform(-0.1, 0.1, 51).astype(np.float32)
    raw = rng.uniform(-1, 1, (2, 60, 34)).astype(np.float32)
    x = (rng.standard_normal((2, 50, c)) * 0.5).astype(np.float32)
    j, t = (lambda a: jnp.asarray(a, jdt)), (lambda a: _t(a).to(tdt))
    blk = ttb.padded_block(c_pad, t(w1), _t(s1), _t(b1), t(w2), _t(s2), _t(b2))
    xp = ttb.pad(t(x), c_pad)
    cases = [
        (jtb.fused_expand_block(j(raw), j(w0), s0, b0, j(w1), s1, b1, j(w2), s2, b2,
                                dilation=3, t_tile=16, interpret=True),
         ttb.fused_expand_block(ttb.pad(t(raw), ci), ttb.pad(t(w0), ci, c_pad),
                                ttb.pad(_t(s0), c_pad), ttb.pad(_t(b0), c_pad), *blk,
                                dilation=3), c),
        (jtb.fused_dilated_block(j(x), j(w1), s1, b1, j(w2), s2, b2, dilation=9,
                                 t_tile=16, interpret=True),
         ttb.fused_dilated_block(xp, *blk, dilation=9), c),
        (jtb.fused_shrink_block(j(x), j(w1), s1, b1, j(w2), s2, b2, j(ws), bs, dilation=3,
                                causal_shift=3, t_tile=16, interpret=True),
         ttb.fused_shrink_block(xp, *blk, ttb.pad(t(ws)[0], c_pad, j3), ttb.pad(_t(bs), j3),
                                dilation=3, causal_shift=3), 51),
    ]
    for want, got, width in cases:
        want = np.asarray(want).astype(np.float32)
        assert tuple(got.shape) == want.shape[:-1] + (got.shape[-1],)
        assert not got[..., width:].any()
        tol = ATOL if dt == "float32" else 2 ** -8 * np.abs(want).max()
        np.testing.assert_allclose(got[..., :width].float().numpy(), want, atol=tol)


@pytest.mark.parametrize("m,k,n", [(4468, 3072, 1024), (4468, 1024, 1024), (4480, 108, 1024),
                                   (3996, 1024, 52), (100, 3072, 1024), (1, 96, 32),
                                   (70_000, 3 * 3636, 3636), (2 * 2070, 3 * 30, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [132, 114])
def test_k3_plan_slices_cover_the_summed_dimension(m, k, n, dtype, sms):
    """The stage GEMMs' slice plan: slices in order, each a whole number of 32-row
    slabs but the last, together [0, k), at most 8; the grid of 128 x 128 tiles
    covers M x N with every tile starting inside it; a grid whose tiles one wave of
    resident CUDA blocks (2 per SM) holds stays in one wave."""
    plan = ttb.k3_plan(m, k, n, sms, dtype)
    assert plan[0][0] == 0 and plan[-1][1] == k and 1 <= len(plan) <= trb.TAP_MAX_SLICES
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert b == c and (b - a) % trb.DW_ROWS == 0
    rows, cols = -(-m // trb.DW_TILE), -(-n // trb.DW_TILE)
    assert (rows - 1) * trb.DW_TILE < m <= rows * trb.DW_TILE
    assert (cols - 1) * trb.DW_TILE < n <= cols * trb.DW_TILE
    if rows * cols <= trb.DW_BLOCKS_PER_SM * sms:
        assert rows * cols * len(plan) <= trb.DW_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, [((0, 108),), tuple((a, a + 512) for a in range(0, 3072, 512)),
                     tuple((a, a + 256) for a in range(0, 1024, 256))]),
    (torch.bfloat16, [((0, 108),), ((0, 1536), (1536, 3072)), ((0, 1024),)]),
])
def test_k3_plan_keeps_its_slices_whatever_k2s_routes(dtype, want, monkeypatch):
    """K3 runs the mma.sync tile at its own rates, apart from K2's: at B = 2,
    T_out = 2,234, C = 1,024 on 132 SMs the expand stage's GEMMs keep their slices
    (the tap GEMM in 6 in float32 and in 2 in bf16, the float32 1x1 in 4) with K2's
    rates (K2_SM_FLOPS, float32's on warpgroup MMAs) at any value."""
    gemms = ttb.k3_gemms("expand", 2, 2242, 2234, 1024, x_cols=36, k0=3)
    assert [ttb.k3_plan(*g, 132, dtype) for g in gemms] == want
    for k2_dtype in (torch.float32, torch.bfloat16):
        monkeypatch.setitem(trb.K2_SM_FLOPS, k2_dtype, 1e15)
    trb.tap_gemm_plan.cache_clear()
    assert [ttb.k3_plan(*g, 132, dtype) for g in gemms] == want
    trb.tap_gemm_plan.cache_clear()


def test_k3_plan_at_the_evaluation_shapes():
    """At B = 2, T = 2,242, C = 1,024 on 132 SMs (the expand stage: 4,468 rows)
    the tap GEMM's 280 tiles, which spill past one wave of 264 resident blocks,
    split in 6 in float32 and in 2 in bf16, the float32 1x1 in 4; the shrink
    stage's 256 tiles stay in one wave, unsplit, and its projection's one column
    of tiles splits in 4."""
    gemms = ttb.k3_gemms("expand", 2, 2242, 2234, 1024, x_cols=36, k0=3)
    assert gemms == [(4480, 108, 1024), (4468, 3072, 1024), (4468, 1024, 1024)]
    assert [len(ttb.k3_plan(*g)) for g in gemms] == [1, 6, 4]
    assert [len(ttb.k3_plan(*g, 132, torch.bfloat16)) for g in gemms] == [1, 2, 1]
    shrink = ttb.k3_gemms("shrink", 2, 2162, 2000, 1024, j3=52)
    assert shrink == [(4000, 3072, 1024), (4000, 1024, 1024), (4000, 1024, 52)]
    assert [len(ttb.k3_plan(*g)) for g in shrink] == [1, 1, 4]
    assert len(ttb.k3_plan(4000, 1024, 56, 132, torch.bfloat16)) == 4
