"""The CUDA kernels against their plain PyTorch versions, on the card: the fused
evaluation blocks (K3), the window gather (K1), the train block with its
backward (K2) and the int8 serving stages (K4, with the accshift tap mode K8).

Needs a CUDA device (marker ``gpu``; skipped elsewhere).  Imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Tolerance, max |kernel - plain| <= tol * max(1, max |plain|): float32 1e-4
(float32 sums in other orders, TF32 off); bfloat16 1.6e-2 (four bf16 steps:
the outputs and intermediates are rounded to bf16, and another summation order
may flip their last bit).  The gather is pure data movement: bitwise equal.
int8 stages: the mid blocks' int8 streams bitwise; expand + block 0 within one
step on at most 1e-3 of its elements (its float64-summed dot may round apart
where the exact sum lies at a float32 midpoint, and a moved e shifts block 0's
per-row requantization); the shrink's float32 output at the float32 bound; the
accshift mode bitwise equal to slice.
"""

import numpy as np
import pytest
import torch

from videopose3d_torch.ops.kernels import gather_rows as gr
from videopose3d_torch.ops.kernels import temporal_block as tb
from videopose3d_torch.ops.kernels import temporal_block_int8 as tq
from videopose3d_torch.ops.kernels import train_block as trb

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _inputs(seed, c, dt, device, c_in=34, j3=51):
    rng = np.random.default_rng(seed)
    t = lambda a, d=dt: torch.from_numpy(np.asarray(a, np.float32)).to(device, d)
    bound = 1 / np.sqrt(3 * c)
    aff = lambda: (t(rng.uniform(0.5, 1.5, c), torch.float32),
                   t(rng.uniform(-0.2, 0.2, c), torch.float32))
    return dict(
        w0=t(rng.uniform(-1, 1, (3, c_in, c)) / np.sqrt(3 * c_in)), bn0=aff(),
        w_taps=t(rng.uniform(-bound, bound, (3, c, c))), bn1=aff(),
        w2=t(rng.uniform(-bound, bound, (c, c))), bn2=aff(),
        ws=t(rng.uniform(-1, 1, (c, j3)) / np.sqrt(c)),
        bs=t(rng.uniform(-0.1, 0.1, j3), torch.float32))


def _check(got, want, dt):
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dt] * max(1.0, float(want.float().abs().max())), err


CASES = [  # channels, dilation, frames, causal shift
    (64, 1, 40, 0),
    (64, 3, 70, 3),       # causal
    (128, 9, 100, 0),
    (64, 1, 19, 0),       # ragged: t_out=17 is not a multiple of the 16-row tile
    (1028, 27, 90, 0),    # two column passes (C > 1024)
    (1024, 81, 200, 0),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d,t,shift", CASES)
def test_dilated_block_kernel_matches_plain(cuda, dt, c, d, t, shift):
    p = _inputs(c + d, c, dt, cuda)
    x = torch.randn(2, t, c, generator=torch.Generator().manual_seed(1)).to(cuda, dt)
    args = (x, p["w_taps"], *p["bn1"], p["w2"], *p["bn2"])
    before = tb.LAUNCHES["dilated"]
    got = tb.fused_dilated_block(*args, dilation=d, causal_shift=shift)
    assert tb.LAUNCHES["dilated"] == before + 1
    _check(got, tb.fused_dilated_block_plain(*args, dilation=d, causal_shift=shift), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d,t,shift", CASES)
def test_expand_block_kernel_matches_plain(cuda, dt, c, d, t, shift):
    p = _inputs(c + d + 1, c, dt, cuda)
    x = torch.rand(2, t + 2, 34, generator=torch.Generator().manual_seed(2)).to(cuda) * 2 - 1
    args = (x, p["w0"], *p["bn0"], p["w_taps"], *p["bn1"], p["w2"], *p["bn2"])
    if (c * (16 + 2 * d) + 16 * c) * 4 > 227 * 1024:
        # The expand window (16 + 2d rows of C floats) and h must fit in
        # shared memory; beyond that the wrapper refuses before launching.
        with pytest.raises(ValueError, match="shared memory"):
            tb.fused_expand_block(*args, dilation=d, causal_shift=shift)
        return
    before = tb.LAUNCHES["expand"]
    got = tb.fused_expand_block(*args, dilation=d, causal_shift=shift)
    assert tb.LAUNCHES["expand"] == before + 1
    _check(got, tb.fused_expand_block_plain(*args, dilation=d, causal_shift=shift), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d,t,shift", CASES)
def test_shrink_block_kernel_matches_plain(cuda, dt, c, d, t, shift):
    p = _inputs(c + d + 2, c, dt, cuda)
    x = torch.randn(2, t, c, generator=torch.Generator().manual_seed(3)).to(cuda, dt)
    args = (x, p["w_taps"], *p["bn1"], p["w2"], *p["bn2"], p["ws"], p["bs"])
    before = tb.LAUNCHES["shrink"]
    got = tb.fused_shrink_block(*args, dilation=d, causal_shift=shift)
    assert tb.LAUNCHES["shrink"] == before + 1
    _check(got, tb.fused_shrink_block_plain(*args, dilation=d, causal_shift=shift), dt)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = _inputs(0, 64, torch.float32, cuda)
    x = torch.randn(2, 40, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tb.fused_dilated_block(x.transpose(0, 1).contiguous().transpose(0, 1),
                               p["w_taps"], *p["bn1"], p["w2"], *p["bn2"], dilation=1)
    with pytest.raises(ValueError, match="dtype"):
        tb.fused_dilated_block(x, p["w_taps"], p["bn1"][0].double(), p["bn1"][1],
                               p["w2"], *p["bn2"], dilation=1)
    with pytest.raises(ValueError, match="multiple of 4"):
        tb.fused_dilated_block(torch.randn(1, 20, 6, device=cuda),
                               torch.randn(3, 6, 6, device=cuda),
                               *[torch.ones(6, device=cuda)] * 2,
                               torch.randn(6, 6, device=cuda),
                               *[torch.ones(6, device=cuda)] * 2, dilation=1)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("fw,causal", [
    ((3,), False), ((3, 3), True), ((3, 3, 3), False), ((3, 3, 3, 3), True),
    ((3, 3, 3, 3, 3), False)])
def test_fused_forward_matches_plain_forward(cuda, dt, fw, causal):
    """The whole fused forward on the card (0-, 1- and multi-block stacks)
    against the plain float32 model on the same weights."""
    from videopose3d_torch.models.temporal import (
        TemporalModel, TemporalModelConfig, forward_dilated, forward_dilated_fused,
        receptive_field)
    torch.manual_seed(0)
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=fw, causal=causal, channels=64,
                              compute_dtype=dt)
    model = TemporalModel(cfg).to(cuda).eval()
    x = torch.rand(2, receptive_field(cfg) + 45, 17, 2, device=cuda) * 2 - 1
    before = dict(tb.LAUNCHES)
    got = forward_dilated_fused(cfg, model, x)
    want = forward_dilated(model, x)
    n_blocks = len(fw) - 1
    launched = {k: tb.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"expand": int(n_blocks >= 1),
                        "dilated": max(n_blocks - 2, 0),
                        "shrink": int(n_blocks >= 2)}
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.cuda.synchronize()
    # bfloat16: activations rounded to bf16 (2^-9 relative) through every layer.
    tol = {"float32": 1e-4, "bfloat16": 3e-2}[dt]
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols,window,batch,out_cols", [
    (4096, 34, 243, 64, None),
    (280_000, 34, 243, 1024, None),   # the full-width training batch
    (512, 51, 1, 64, None),           # 3D-target-sized windows
    (300, 34, 27, 16, 17),            # a column prefix
    (100, 33, 9, 8, None),            # odd row width: 2- or 4-byte words
])
def test_gather_kernel_matches_plain(cuda, dt, rows, cols, window, batch, out_cols):
    g = torch.Generator().manual_seed(rows + window)
    flat = torch.randn(rows, cols, generator=g).to(cuda, dt)
    # Out-of-range first rows are clamped to [0, rows - window] by both versions.
    row0 = torch.randint(-20, rows + 20, (batch,), generator=g).to(cuda)
    before = gr.LAUNCHES["gather_windows"]
    got = gr.gather_windows(flat, row0, window=window, out_cols=out_cols)
    assert gr.LAUNCHES["gather_windows"] == before + 1
    want = gr.gather_windows_plain(flat, row0, window=window, out_cols=out_cols)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


def _train_block_inputs(seed, b, t, c, fw, dt, dropout, device):
    rng = np.random.default_rng(seed)
    f = lambda a, d=dt: torch.from_numpy(np.asarray(a, np.float32)).to(device, d)
    bound = 1 / np.sqrt(fw * c)
    masks = [None, None]
    if dropout:
        masks = [f((rng.uniform(size=(b, t // fw, c)) < 0.75) / 0.75) for _ in range(2)]
    return dict(
        x=f(rng.standard_normal((b, t, c))),
        wa=f(rng.uniform(-bound, bound, (fw, c, c))),
        wb=f(rng.uniform(-1, 1, (c, c)) / np.sqrt(c)),
        bn=[f(rng.uniform(lo, hi, c), torch.float32)
            for lo, hi in ((0.5, 1.5), (-0.2, 0.2), (0.5, 1.5), (-0.2, 0.2))],
        masks=masks,
        shifts=[f(rng.uniform(-0.1, 0.1, c), torch.float32) for _ in range(2)],
        g=f(rng.standard_normal((b, t // fw, c))))


def _block_run(p, fw, center, plain):
    """Forward and backward of one block; returns out, stats and all gradients."""
    leaves = [p["x"], p["wa"], p["wb"], *p["bn"]]
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    outs = trb.fused_train_block(*leaves, *p["masks"], *p["shifts"], center=center,
                                 fw=fw, plain=plain)
    grads = torch.autograd.grad(outs[0], leaves, p["g"])
    return [o.detach() for o in outs] + list(grads)


TRAIN_BLOCK_CASES = [  # batch, frames, channels, fw, center, dropout
    (8, 27, 64, 3, 1, True),
    (7, 15, 64, 5, 4, False),        # causal center, n = 21 rows
    (5, 9, 1028, 3, 1, True),        # two column passes (C > 1024), ragged tile
    (1024, 3, 1024, 3, 1, True),     # the last full-width block, n = 1,024
]


@pytest.mark.parametrize("b,t,c,fw,center,dropout", TRAIN_BLOCK_CASES)
def test_train_block_kernels_match_plain(cuda, b, t, c, fw, center, dropout):
    """float32: out, both stat pairs and every gradient within 1e-4 of the
    plain versions (float32 sums in other orders), all seven kernels launched."""
    p = _train_block_inputs(b * c + fw, b, t, c, fw, torch.float32, dropout, cuda)
    before = dict(trb.LAUNCHES)
    got = _block_run(p, fw, center, plain=False)
    launched = {k: trb.LAUNCHES[k] - before[k] for k in before}
    assert launched == {**{k: 1 for k in launched}, "relu_mask_bn_sums": 2}
    want = _block_run(p, fw, center, plain=True)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        _check(a, w, torch.float32)


@pytest.mark.parametrize("b,t,c,fw,center,dropout", TRAIN_BLOCK_CASES[:3])
def test_train_block_bf16_kernels_match_plain(cuda, b, t, c, fw, center, dropout):
    """bfloat16, each kernel against its plain version on the same inputs (the
    plain chain's), so a pre-activation that rounds across 0 gates both alike."""
    p = _train_block_inputs(b * c + fw + 1, b, t, c, fw, torch.bfloat16, dropout, cuda)
    n = b * (t // fw)
    x3 = p["x"].reshape(n, fw, c)
    ma, mb = [None if m is None else m.reshape(n, c) for m in p["masks"]]
    pairs = []
    args = (x3, p["wa"], p["shifts"][0])
    pairs.append((trb.conv_stats(*args, center=center),
                  trb.conv_stats_plain(*args, center=center)))
    u = pairs[-1][1][0]
    stat = torch.stack([p["shifts"][0], torch.rsqrt(p["bn"][0] + 1e-5)])
    gate = torch.stack([p["shifts"][0], p["bn"][0], p["bn"][1]]).to(torch.bfloat16)
    args = (u, ma, gate, p["wb"], p["shifts"][1])
    pairs.append((trb.norm_drop_matmul_stats(*args), trb.norm_drop_matmul_stats_plain(*args)))
    d, v = pairs[-1][1][:2]
    args = (v, mb, gate, u)
    pairs.append((trb.norm_drop_res(*args), trb.norm_drop_res_plain(*args)))
    g2 = p["g"].reshape(n, c)
    args = (g2, v, mb, stat, gate)
    pairs.append((trb.relu_mask_bn_sums(*args), trb.relu_mask_bn_sums_plain(*args)))
    coef = torch.stack([p["bn"][0], p["bn"][1], p["bn"][3], stat[1], p["shifts"][0]])
    args = (pairs[-1][1][0], v, coef, p["wb"])
    pairs.append((trb.dz_matmul_dd(*args), trb.dz_matmul_dd_plain(*args)))
    args = (d, pairs[-1][1][0])
    pairs.append(((trb.dw_gemm(*args),), (trb.dw_gemm_plain(*args),)))
    args = (g2, u, g2, coef, p["wa"])
    pairs.append((trb.du_dtaps_res(*args, center=center),
                  trb.du_dtaps_res_plain(*args, center=center)))
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, w in zip(got, want):
            assert a.shape == w.shape and a.dtype == w.dtype
            # float32 sums of bf16 values: one operand rounded one bf16 step
            # apart moves a sum by that step, so the bf16 bound holds for all.
            _check(a, w, torch.bfloat16)


def _int8_model(c, fw, causal, frames, device, seed=0):
    """A random model (random BatchNorm statistics), quantized on the card."""
    from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                    receptive_field)
    torch.manual_seed(seed)
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=fw, causal=causal, channels=c)
    model = TemporalModel(cfg)
    for bn in [model.expand_bn, *model.layers_bn]:
        bn.running_var.uniform_(0.5, 2.0)
        bn.bias.data.uniform_(-0.2, 0.2)
    model = model.to(device).eval()
    x = torch.rand(2, receptive_field(cfg) + frames, 17, 2, device=device) * 2 - 1
    q = tq.quantize_temporal_model(cfg, model, x)
    return cfg, model, q, x


def _int8_stages(cfg, q, x):
    """(name, key, kernel(x, mode), plain(x, mode)) per stage, each fed the plain
    output of the stage before (expand first, from the pre-tapped keypoints)."""
    k0, c_in, c = q.expand_w.shape
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    t_e = flat.shape[1] - (k0 - 1)
    taps = torch.cat([flat[:, j: j + t_e] for j in range(k0)], -1).to(torch.bfloat16)
    w0 = q.expand_w.reshape(k0 * c_in, c)
    n = len(q.blocks)
    geo = [dict(dilation=d, causal_shift=s)
           for d, s in zip(cfg.dilations[1:], cfg.causal_shifts_dilated[1:])]
    stages = [("expand", "int8_expand", taps,
               lambda v, m: tq.int8_expand_block(v, w0, q.expand_scale, q.expand_shift,
                                                 q.blocks[0], tap_mode=m, **geo[0]),
               lambda v, m: tq.int8_expand_block_plain(v, w0, q.expand_scale,
                                                       q.expand_shift, q.blocks[0],
                                                       tap_mode=m, **geo[0]))]
    for i in range(1, n - 1):
        stages.append((f"mid {i}", "int8_dilated", None,
                       lambda v, m, i=i: tq.int8_dilated_block(v, q.blocks[i], tap_mode=m,
                                                               **geo[i]),
                       lambda v, m, i=i: tq.int8_dilated_block_plain(v, q.blocks[i],
                                                                     tap_mode=m, **geo[i])))
    stages.append(("shrink", "int8_shrink", None,
                   lambda v, m: tq.int8_shrink_block(v, q.blocks[-1], q.shrink_w,
                                                     q.shrink_b, tap_mode=m, **geo[-1]),
                   lambda v, m: tq.int8_shrink_block_plain(v, q.blocks[-1], q.shrink_w,
                                                           q.shrink_b, tap_mode=m,
                                                           **geo[-1])))
    return stages


INT8_CASES = [  # channels, filter widths, causal, frames past the receptive field
    (64, (3, 3, 3), False, 45),
    (64, (3, 3, 3, 3), True, 19),     # ragged: 20 output rows, causal offsets
    (80, (5, 5, 5), False, 10),       # 5 taps, a channel count below a full warp pass
    (1040, (3, 3, 3), False, 30),     # two column passes (C > 1024)
    (1024, (3, 3, 3, 3, 3), False, 200),
]


@pytest.mark.parametrize("c,fw,causal,frames", INT8_CASES)
def test_int8_stage_kernels_match_plain(cuda, c, fw, causal, frames):
    cfg, _, q, x = _int8_model(c, fw, causal, frames, cuda, seed=c + len(fw))
    v = None
    for name, key, first, kernel, plain in _int8_stages(cfg, q, x):
        v = first if first is not None else v
        want = plain(v, "slice")
        got = {}
        for mode in ("slice", "accshift"):
            counter = key + ("_accshift" if mode == "accshift" else "")
            before = tq.LAUNCHES[counter]
            got[mode] = kernel(v, mode)
            assert tq.LAUNCHES[counter] == before + 1
            torch.cuda.synchronize()
            assert got[mode].shape == want.shape and got[mode].dtype == want.dtype, name
        assert torch.equal(got["accshift"], got["slice"]), name
        if key == "int8_shrink":
            _check(got["slice"], want, torch.float32)
        else:
            diff = (got["slice"].int() - want.int()).abs()
            if key == "int8_dilated":
                assert int(diff.max()) == 0, name
            else:
                assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
        v = want


def test_int8_forward_matches_plain_stages_and_f32(cuda):
    """The whole int8 forward on the card: the plain stage chain's poses within
    the shrink bound, and within 0.06 * RMS of the float32 model."""
    from videopose3d_torch.evaluate import full_float32
    from videopose3d_torch.models.temporal import forward_dilated, forward_dilated_int8
    cfg, model, q, x = _int8_model(128, (3, 3, 3, 3), False, 60, cuda)
    before = dict(tq.LAUNCHES)
    got = forward_dilated_int8(cfg, q, x)
    launched = {k: tq.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"int8_expand": 1, "int8_dilated": 1, "int8_shrink": 1,
                        "int8_expand_accshift": 0, "int8_dilated_accshift": 0,
                        "int8_shrink_accshift": 0}
    v = None
    for _, _, first, _, plain in _int8_stages(cfg, q, x):
        v = plain(first if first is not None else v, "slice")
    _check(got, v.reshape(got.shape), torch.float32)
    with full_float32():
        want = forward_dilated(model, x)
    per_joint = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
    assert per_joint < 0.06 * float(want.square().mean().sqrt())


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    cfg, _, q, _ = _int8_model(64, (3, 3, 3), False, 10, cuda)
    xs = torch.zeros(2, 40, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        tq.int8_dilated_block(xs.float(), q.blocks[0], dilation=3)
    with pytest.raises(ValueError, match="aligned"):
        tq.int8_dilated_block(torch.zeros(2 * 40 * 64 + 1, dtype=torch.int8,
                                          device=cuda)[1:].view(2, 40, 64),
                              q.blocks[0], dilation=3)
    _, _, q24, _ = _int8_model(24, (3, 3, 3), False, 10, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        tq.int8_dilated_block(torch.zeros(2, 40, 24, dtype=torch.int8, device=cuda),
                              q24.blocks[0], dilation=3)
