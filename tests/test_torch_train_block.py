"""The fused train block of videopose3d_torch (``FusedTrainBlock``: the plain
versions of kernel K2 inside its ``autograd.Function``) against the JAX package's
``fused_train_block`` (Pallas, interpret mode on the CPU) on identical inputs:
the output, both BatchNorm statistic pairs and every gradient.

Where n = B * T/fw is not a multiple of 8 the Pallas kernels have no row tile (the
JAX model falls back to its XLA block); the port's block takes any n, so there it
is held against the same block written in JAX ops.

Tolerances are the JAX package's own for its train block
(``tests/test_train_block.py``): values rtol 1e-5 / atol 1e-6, gradients rtol 2e-5 /
atol 2e-5 times the largest gradient.  bfloat16 is held against the port's plain
bf16 engine as the JAX package holds its bf16 block: values to 5e-3, gradients by
cosine similarity above 0.995 (a bf16 pre-activation that rounds across 0 in one
engine and not the other flips a ReLU gate)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu.models.temporal import BN_EPS
from videopose3d_tpu.ops.pallas.train_block import fused_train_block as jax_block
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                forward_strided, receptive_field)
from videopose3d_torch.ops.kernels import train_block as trb


def _inputs(seed, b, t, c, fw, dropout):
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(fw * c)
    f32 = lambda a: np.asarray(a, np.float32)
    masks = [None, None]
    if dropout:
        masks = [f32((rng.uniform(size=(b, t // fw, c)) < 0.75) / 0.75) for _ in range(2)]
    return dict(
        diff=[f32(rng.standard_normal((b, t, c))),
              f32(rng.uniform(-bound, bound, (fw, c, c))),
              f32(rng.uniform(-1, 1, (c, c)) / np.sqrt(c)),
              f32(rng.uniform(0.5, 1.5, c)), f32(rng.uniform(-0.2, 0.2, c)),
              f32(rng.uniform(0.5, 1.5, c)), f32(rng.uniform(-0.2, 0.2, c))],
        masks=masks,
        shifts=[f32(rng.uniform(-0.1, 0.1, c)) for _ in range(2)],
        g=f32(rng.standard_normal((b, t // fw, c))))


def _jax_xla_block(center, fw, x, wa, wb, sa, ba, sb, bb, mask_a, mask_b, shift_a,
                   shift_b):
    """The block in JAX ops, with the statistics of ``models/temporal._batchnorm``."""
    b, t, c = x.shape
    taps = x.reshape(b, t // fw, fw * c)
    res = taps[:, :, center * c:(center + 1) * c]

    def bn(y, scale, bias, shift):
        centered = y - shift
        m1 = jnp.mean(centered, axis=(0, 1))
        mean = shift + m1
        var = jnp.maximum(jnp.mean(centered * centered, axis=(0, 1)) - m1 * m1, 0.0)
        inv = jax.lax.rsqrt(var + BN_EPS) * scale
        stats = (jax.lax.stop_gradient(mean), jax.lax.stop_gradient(var))
        return (y - mean) * inv + bias, stats

    y, (mean_a, var_a) = bn(taps @ wa.reshape(fw * c, c), sa, ba, shift_a)
    y = jax.nn.relu(y) * mask_a
    y, (mean_b, var_b) = bn(y @ wb, sb, bb, shift_b)
    return res + jax.nn.relu(y) * mask_b, mean_a, var_a, mean_b, var_b


@pytest.mark.parametrize("b,t,c,fw,center,dropout", [
    (8, 9, 32, 3, 1, True),
    (8, 9, 32, 3, 1, False),
    (8, 9, 32, 3, 2, True),      # causal: the residual is the last tap
    (8, 15, 32, 5, 2, True),
    (8, 15, 32, 5, 4, False),    # causal
    (7, 9, 32, 3, 1, True),      # n = 21, not a multiple of 8
])
def test_train_block_matches_jax(b, t, c, fw, center, dropout):
    p = _inputs(b * 100 + t + fw + center, b, t, c, fw, dropout)
    n = b * (t // fw)
    ones = np.ones((b, t // fw, c), np.float32)
    masks = [ones if m is None else m for m in p["masks"]]
    if n % 8 == 0:
        fn = lambda *d: jax_block(center, fw, True, *d, *masks, *p["shifts"])
    else:
        fn = lambda *d: _jax_xla_block(center, fw, *d, *masks, *p["shifts"])
    want, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in p["diff"]])
    zeros = [jnp.zeros_like(w) for w in want[1:]]
    want_grads = vjp((jnp.asarray(p["g"]), *zeros))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in p["diff"]]
    t_ = lambda a: None if a is None else torch.from_numpy(a)
    got = trb.fused_train_block(*leaves, *map(t_, p["masks"]), *map(t_, p["shifts"]),
                                center=center, fw=fw)
    got_grads = torch.autograd.grad(got[0], leaves, torch.from_numpy(p["g"]))

    for i, (a, w) in enumerate(zip(got, want)):
        assert tuple(a.shape) == w.shape, i
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=f"output {i}")
    for i, (a, w) in enumerate(zip(got_grads, want_grads)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(a.numpy(), w, rtol=2e-5, atol=2e-5 * scale,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("c", [68, 1024, 1028])
@pytest.mark.parametrize("n", [1, 31, 1024, 27_648])
def test_dw_gemm_plan_tiles_the_rows(n, c):
    """dw_gemm's split over the rows: in-order slices that tile [0, n) exactly,
    all but the last of one whole number of slabs, and no more CUDA blocks than
    one wave of the card holds (132 SMs)."""
    plan = trb.dw_gemm_plan(n, c, sms=132)
    assert len(plan) >= 1 and plan[0][0] == 0 and plan[-1][1] == n
    assert all(stop == start for (_, stop), (start, _) in zip(plan, plan[1:]))
    rows = plan[0][1]
    assert all(stop - start == rows for start, stop in plan[:-1])
    assert 0 < plan[-1][1] - plan[-1][0] <= rows
    assert len(plan) == 1 or rows % trb.DW_ROWS == 0
    tiles = (-(-c // trb.DW_TILE)) ** 2
    assert len(plan) * tiles <= max(tiles, trb.DW_BLOCKS_PER_SM * 132)
    if (n, c) == (27_648, 1024):  # the first residual block: 4 x 64 CUDA blocks
        assert plan == [(0, 6912), (6912, 13824), (13824, 20736), (20736, 27648)]


@pytest.mark.parametrize("m,k,n", [
    (1, 204, 68), (31, 204, 68), (129, 3084, 1028), (1024, 3072, 1024),
    (3072, 3072, 1024), (9216, 3072, 1024), (27_648, 3072, 1024),  # conv_stats
    (1024, 1024, 3072), (27_648, 1024, 3072), (129, 68, 204),      # du_dtaps_res
])
def test_tap_gemm_plan_slices_the_summed_dimension(m, k, n):
    """The tap GEMMs' split over their summed dimension: in-order slices that
    tile [0, k) exactly, all but the last of one whole number of slabs, at most
    TAP_MAX_SLICES of them; the training step's shapes split as the slice
    sweeps on the card found fastest (132 SMs)."""
    plan = trb.tap_gemm_plan(m, k, n, sms=132)
    assert len(plan) >= 1 and plan[0][0] == 0 and plan[-1][1] == k
    assert all(stop == start for (_, stop), (start, _) in zip(plan, plan[1:]))
    rows = plan[0][1]
    assert all(stop - start == rows for start, stop in plan[:-1])
    assert 0 < plan[-1][1] - plan[-1][0] <= rows
    assert len(plan) == 1 or rows % trb.DW_ROWS == 0
    assert len(plan) <= trb.TAP_MAX_SLICES
    want = {(1024, 3072, 1024): 2, (3072, 3072, 1024): 2, (9216, 3072, 1024): 2,
            (27_648, 3072, 1024): 1, (1024, 1024, 3072): 2, (27_648, 1024, 3072): 1}
    if (m, k, n) in want:
        assert len(plan) == want[(m, k, n)]


@pytest.mark.parametrize("c,limit", [(1024, None), (3632, None), (1030, "multiple of 4"),
                                     (3636, "at most 3632 channels")])
def test_channel_limit_error_names_the_limit(c, limit):
    """The train-block kernels' width limits, known without the card: 16-byte
    rows, and a 16 x C float32 tile in 232,448 bytes of shared memory."""
    err = trb.channel_limit_error(c)
    if limit is None:
        assert err is None and trb.tile_smem_bytes(c) <= trb.SMEM_OPT_IN
    else:
        assert limit in err and "--train-engine xla" in err


def test_bf16_fused_engine_matches_plain_bf16_engine():
    """compute_dtype bfloat16: the fused engine's plain bodies against the plain
    bf16 block, whole model, same weights and dropout masks."""
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=(3, 3, 3), dropout=0.25, channels=32,
                              compute_dtype="bfloat16")
    torch.manual_seed(3)
    base = TemporalModel(cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, receptive_field(cfg), 17, 2)).astype(np.float32))
    results = []
    for engine in ("xla", "pallas"):
        model = TemporalModel(dataclasses.replace(cfg, train_engine=engine))
        model.load_state_dict(base.state_dict())
        pred = forward_strided(model, x, momentum=0.1,
                               generator=torch.Generator().manual_seed(11))
        loss = (pred * torch.cos(torch.arange(pred.numel()).reshape(pred.shape))).sum()
        loss.backward()
        grads = [p.grad.double().ravel() for p in model.parameters()]
        results.append((float(loss.detach()), grads, [b.clone() for b in model.buffers()]))
    (loss_x, grads_x, bufs_x), (loss_p, grads_p, bufs_p) = results
    np.testing.assert_allclose(loss_p, loss_x, rtol=5e-3, atol=5e-3)
    for a, b in zip(bufs_p, bufs_x):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-3)
    for a, b in zip(grads_p, grads_x):
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > 0.995, cos
