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
    (8, 9, 30, 3, 1, True),      # C % 4 != 0: the port pads to 32 zero channels
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


@pytest.mark.parametrize("m,c", [
    pytest.param(68, 68, id="68"), pytest.param(1024, 1024, id="1024"),
    pytest.param(1028, 1028, id="1028"),
    pytest.param(3072, 1024, id="dWa-3072x1024"),  # dWa = x3^T du: fw C x C
])
@pytest.mark.parametrize("n", [1, 31, 64, 128, 384, 1024, 27_648, 55_296,
                               3072, 9216, 2048, 6144, 18_432])
def test_dw_gemm_plan_tiles_the_rows(n, m, c):
    """dw_gemm's split over the rows for an (m, c) output (dWb: C x C, dWa:
    3 C x C): in-order slices that tile [0, n) exactly, all but the last of one
    whole number of slabs, at most TAP_MAX_SLICES of them; at the steps' shapes
    both weight gradients split in 2, as the slice sweeps on the card found
    fastest (132 SMs)."""
    plan = trb.dw_gemm_plan(n, m, c, sms=132)
    assert len(plan) >= 1 and plan[0][0] == 0 and plan[-1][1] == n
    assert all(stop == start for (_, stop), (start, _) in zip(plan, plan[1:]))
    rows = plan[0][1]
    assert all(stop - start == rows for start, stop in plan[:-1])
    assert 0 < plan[-1][1] - plan[-1][0] <= rows
    assert len(plan) == 1 or rows % trb.DW_ROWS == 0
    assert len(plan) <= trb.TAP_MAX_SLICES
    if (n, m, c) == (27_648, 1024, 1024):  # the first residual block: 2 x 64 CUDA blocks
        assert plan == [(0, 13824), (13824, 27648)]
    if c == 1024 and n >= 1024:  # dWb's 64 tiles and dWa's 192 at every n of the steps
        assert len(plan) == 2


@pytest.mark.parametrize("m,k,n", [
    (1, 204, 68), (31, 204, 68), (129, 3084, 1028), (1024, 3072, 1024),
    (3072, 3072, 1024), (9216, 3072, 1024), (27_648, 3072, 1024),  # conv_stats
    (1024, 1024, 3072), (27_648, 1024, 3072), (129, 68, 204),      # du_dtaps_res
    (1024, 1024, 1024), (3072, 1024, 1024), (9216, 1024, 1024),    # the one-tap
    (27_648, 1024, 1024),                                          # GEMMs
    # semi-supervised training: -arc 3,3,3 -b 64 (n = 64 to 384) and the doubled
    # batch of -arc 3,3,3,3,3 -b 1024 (n = 55,296)
    (64, 3072, 1024), (128, 3072, 1024), (384, 3072, 1024), (55_296, 3072, 1024),
    (64, 1024, 3072), (384, 1024, 3072), (55_296, 1024, 3072),
    (64, 1024, 1024), (128, 1024, 1024), (384, 1024, 1024), (55_296, 1024, 1024),
    (3072, 1024, 3072), (9216, 1024, 3072),  # du_dtaps_res at the supervised n
    # the other row counts of the semi step's blocks (n = 2,048 / 6,144 / 18,432)
    (2048, 3072, 1024), (6144, 3072, 1024), (18_432, 3072, 1024),
    (2048, 1024, 3072), (6144, 1024, 3072), (18_432, 1024, 3072),
    (2048, 1024, 1024), (6144, 1024, 1024), (18_432, 1024, 1024),
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
            (27_648, 3072, 1024): 1, (1024, 1024, 3072): 2, (27_648, 1024, 3072): 1,
            (1024, 1024, 1024): 2, (3072, 1024, 1024): 2, (9216, 1024, 1024): 1,
            (27_648, 1024, 1024): 1}
    if (m, k, n) in want:
        assert len(plan) == want[(m, k, n)]


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("c", [4, 68, 1024, 1028, 3636])
@pytest.mark.parametrize("n", [1, 31, 64, 127, 128, 192, 384, 1000, 1024, 3072, 9216,
                               27_648, 27_649, 55_296])
def test_relu_sums_plan_tiles_the_rows(n, c, esize):
    """relu_mask_bn_sums's row slices, one CUDA block of each column strip per
    slice and a cluster per strip: in-order slices of one length but the last
    that tile [0, n) exactly, at most SUM_MAX_CLUSTER of them, none shorter than
    SUM_SLOTS rows when there are several, and the cluster doubled wherever the
    grid kept under SUM_BYTES_IN_FLIGHT of loads in flight and the rows allowed
    it."""
    plan = trb.relu_sums_plan(n, c, esize)
    assert len(plan) >= 1 and plan[0][0] == 0 and plan[-1][1] == n
    assert all(stop == start for (_, stop), (start, _) in zip(plan, plan[1:]))
    rows = plan[0][1]
    assert all(stop - start == rows for start, stop in plan[:-1])
    assert 0 < plan[-1][1] - plan[-1][0] <= rows
    k = len(plan)
    assert k in (1, 2, 4, 8, 16) and k <= trb.SUM_MAX_CLUSTER
    assert k == 1 or rows >= trb.SUM_SLOTS
    in_flight = (-(-c // trb.SUM_COLS) * k * trb.SUM_SLOTS * trb.SUM_UNROLL * 3
                 * trb.SUM_COLS * esize)
    assert (k == trb.SUM_MAX_CLUSTER or in_flight >= trb.SUM_BYTES_IN_FLIGHT
            or n < 2 * k * trb.SUM_SLOTS)


@pytest.mark.parametrize("esize,k", [(4, 8), (2, 16)])
@pytest.mark.parametrize("n", [1024, 3072, 9216, 27_648, 2048, 6144, 18_432, 55_296])
def test_relu_sums_plan_fills_the_card_at_the_training_shapes(n, esize, k):
    """At the training step's four block shapes (C = 1,024), and at the doubled
    ones of a semi-supervised step after warmup, the grid covers
    every SM of an H100 (132): 32 column strips in clusters of 8 (float32, 256
    CUDA blocks) or 16 (bf16, 512), 6 MiB of loads in flight either way."""
    plan = trb.relu_sums_plan(n, 1024, esize)
    assert len(plan) == k
    assert len(plan) * (1024 // trb.SUM_COLS) >= 132


@pytest.mark.parametrize("c,limit", [(1024, None), (3632, None), (1030, None),
                                     (3636, None)])
def test_channel_limit_error_names_the_limit(c, limit):
    """The train block takes any width, as the JAX package's: the tap GEMMs hold
    nothing per channel in shared memory (no ceiling), and fused_train_block pads
    C % 4 != 0 with zero channels.  Only an empty channel axis is refused."""
    assert trb.channel_limit_error(c) == limit
    assert "at least one channel" in trb.channel_limit_error(0)


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
