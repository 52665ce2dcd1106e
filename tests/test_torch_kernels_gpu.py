"""The CUDA kernels against their plain PyTorch versions, on the card: the fused
evaluation blocks (K3), the window gather (K1), the train block with its
backward (K2), the int8 serving stages (K4, with the accshift tap mode K8), and
the streaming step (K5 per frame, K6 k frames; int8 and bf16) with the ring
push (K7).

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
accshift mode bitwise equal to slice.  Streaming: int8 rings bitwise at every
step and poses at the float32 bound (the shrink's float32 sums); bf16 each step
from one shared state at the bf16 bound; the ring push bitwise.
"""

import numpy as np
import pytest
import torch

from videopose3d_torch.ops.kernels import gather_rows as gr
from videopose3d_torch.ops.kernels import streaming_fused as sf
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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols,window,out_cols", [
    (4096, 34, 243, None),         # the training batch's rows: 136 bytes in float32
    (4096, 33, 243, None),         # odd row width: every even phase in bfloat16
    (4096, 34, 1, None),           # one-row windows: head and tail only
    (4096, 34, 27, 17),            # a column prefix
    (3_000_000, 34, 243, None),    # a stream past the 50 MB L2, as a real epoch's
])
def test_gather_kernel_at_every_16_byte_phase(cuda, dt, rows, cols, window, out_cols):
    """Window starts of both parities at even and odd batch indices: a float32
    window of 34 columns then starts at 0 or 8 (mod 16) in the stream and in the
    output in all four pairs, and the copy is bitwise equal at each."""
    flat = torch.randn(rows, cols, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(rows + cols)).to(dt)
    rng = np.random.default_rng(window)
    starts = rng.integers(0, rows - window, 64)
    row0 = starts - starts % 2 + np.tile([0, 1, 1, 0], 16)
    row0 = torch.from_numpy(row0.astype(np.int32)).to(cuda)
    before = gr.LAUNCHES["gather_windows"]
    got = gr.gather_windows(flat, row0, window=window, out_cols=out_cols)
    assert gr.LAUNCHES["gather_windows"] == before + 1
    want = gr.gather_windows_plain(flat, row0, window=window, out_cols=out_cols)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)
    if dt == torch.float32 and cols == 34 and out_cols is None:
        row_bytes, span = cols * 4, window * cols * 4
        phases = {((flat.data_ptr() + r * row_bytes) % 16, (got.data_ptr() + b * span) % 16)
                  for b, r in enumerate(row0.tolist())}
        assert phases == {(0, 0), (0, 8), (8, 0), (8, 8)}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [68, 1024, 1028])
@pytest.mark.parametrize("n", [1, 31, 33, 1024, 27_648])
def test_dw_gemm_kernel_matches_plain(cuda, dt, n, c):
    """dWb = a^T b over n rows (one or several row slices, ragged slabs and
    output tiles): within tolerance of the plain version, one launch counted
    per call, and two launches bitwise equal (the slices are added in a fixed
    order, without atomics)."""
    gen = torch.Generator(cuda).manual_seed(n * c)
    a = torch.randn(n, c, device=cuda, generator=gen).to(dt)
    b = torch.randn(n, c, device=cuda, generator=gen).to(dt)
    before = trb.LAUNCHES["dw_gemm"]
    got = trb.dw_gemm(a, b)
    assert trb.LAUNCHES["dw_gemm"] == before + 1
    again = trb.dw_gemm(a, b)
    assert trb.LAUNCHES["dw_gemm"] == before + 2
    _check(got, trb.dw_gemm_plain(a, b), dt)
    assert torch.equal(got, again)


def test_dw_gemm_refuses_misaligned_rows(cuda):
    flat = torch.randn(33 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        trb.dw_gemm(flat[1:].view(33, 64), torch.randn(33, 64, device=cuda))


TAP_CENTERS = [(1, 0), (3, 0), (3, 1), (3, 2)]  # filter width, residual tap


def _tap_inputs(n, c, fw, dt, dropout, device):
    """Seeded inputs of conv_stats and du_dtaps_res; with dropout a quarter of
    the activations are zero, as behind a dropout mask."""
    gen = torch.Generator(device).manual_seed(n * 7 + c * 3 + fw)
    f = lambda *shape, scale=1.0: (torch.randn(*shape, device=device, generator=gen)
                                   * scale).to(dt)
    keep = lambda t: (t * (torch.rand(t.shape, device=device, generator=gen) < 0.75).to(dt)
                      if dropout else t)
    coef = torch.stack([torch.rand(c, device=device, generator=gen) + 0.5,
                        torch.randn(c, device=device, generator=gen) * 0.1,
                        torch.randn(c, device=device, generator=gen) * 0.1,
                        torch.rand(c, device=device, generator=gen) + 0.5,
                        torch.randn(c, device=device, generator=gen) * 0.1])
    return dict(x3=keep(f(n, fw, c)), wa=f(fw, c, c, scale=1 / np.sqrt(fw * c)),
                shift=torch.randn(c, device=device, generator=gen) * 0.1,
                ga=keep(f(n, c)), u=f(n, c), g=f(n, c, scale=1e-3), coef=coef)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fw,center", TAP_CENTERS)
@pytest.mark.parametrize("c", [68, 1024, 1028])
@pytest.mark.parametrize("n", [1, 31, 129, 1024, 27_648])
def test_conv_stats_kernel_matches_plain(cuda, n, c, fw, center, dt, dropout):
    """The tap GEMM u = x3 @ Wa with its residual tap and BatchNorm partial sums
    (ragged row and column tiles, slabs and summed-dimension slices): within
    tolerance of the plain version, one launch counted per call, and two
    launches bitwise equal (tiles and slices summed in a fixed order)."""
    p = _tap_inputs(n, c, fw, dt, dropout, cuda)
    args = (p["x3"], p["wa"], p["shift"])
    before = trb.LAUNCHES["conv_stats"]
    got = trb.conv_stats(*args, center=center)
    again = trb.conv_stats(*args, center=center)
    assert trb.LAUNCHES["conv_stats"] == before + 2
    want = trb.conv_stats_plain(*args, center=center)
    for a, w in zip(got, want):
        _check(a, w, dt)
    assert torch.equal(got[1], want[1])  # the residual tap is a copy
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fw,center", TAP_CENTERS)
@pytest.mark.parametrize("c", [68, 1024, 1028])
@pytest.mark.parametrize("n", [1, 31, 129, 1024, 27_648])
def test_du_dtaps_res_kernel_matches_plain(cuda, n, c, fw, center, dt, dropout):
    """du = the BatchNorm input gradient, then the tap GEMM dx3 = du @ Wa^T with
    the residual cotangent added to the center tap: within tolerance of the
    plain version, one launch counted per call, two launches bitwise equal."""
    p = _tap_inputs(n, c, fw, dt, dropout, cuda)
    args = (p["ga"], p["u"], p["g"], p["coef"], p["wa"])
    before = trb.LAUNCHES["du_dtaps_res"]
    got = trb.du_dtaps_res(*args, center=center)
    again = trb.du_dtaps_res(*args, center=center)
    assert trb.LAUNCHES["du_dtaps_res"] == before + 2
    want = trb.du_dtaps_res_plain(*args, center=center)
    for a, w in zip(got, want):
        _check(a, w, dt)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_tap_gemm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x3 = torch.randn(16, 3, 64, device=cuda)
    wa = torch.randn(3, 64, 64, device=cuda)
    flat = torch.randn(16 * 3 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        trb.conv_stats(flat[1:].view(16, 3, 64), wa, torch.zeros(64, device=cuda), center=1)
    with pytest.raises(ValueError, match="multiple of 4"):
        trb.conv_stats(torch.randn(16, 3, 6, device=cuda),
                       torch.randn(3, 6, 6, device=cuda), torch.zeros(6, device=cuda),
                       center=1)
    with pytest.raises(ValueError, match="center tap"):
        trb.conv_stats(x3, wa, torch.zeros(64, device=cuda), center=3)
    # 3,636 channels pass the tap GEMMs (no 16 x C tile), not the row-tile kernels.
    c = 3636
    assert trb.channel_limit_error(c) is not None
    p = _tap_inputs(4, c, 1, torch.float32, False, cuda)
    args = (p["ga"], p["u"], p["g"], p["coef"], p["wa"])
    got = trb.du_dtaps_res(*args, center=0)
    for a, w in zip(got, trb.du_dtaps_res_plain(*args, center=0)):
        _check(a, w, torch.float32)
    u = p["u"]
    with pytest.raises(ValueError, match="3632 channels"):
        trb.dz_matmul_dd(u, u, torch.ones(5, c, device=cuda),
                         torch.randn(c, c, device=cuda))


def test_width_mirrors_equal_the_kernels_own(cuda):
    """channel_limit_error's pure-Python shared-memory formulas equal the ones the
    CUDA sources report."""
    from videopose3d_torch.ops.kernels.build import load_library
    lib = load_library()
    assert trb.SMEM_OPT_IN == tb.SMEM_OPT_IN == lib.vp3d_block_max_smem_bytes()
    for c in (4, 68, 1024, 1028, 3632, 3636):
        assert trb.tile_smem_bytes(c) == lib.vp3d_tb_smem_bytes(c)
        for kind, c_in, k0, span in (("dilated", 0, 0, 0), ("shrink", 0, 0, 0),
                                     ("expand", 34, 3, 6), ("expand", 33, 5, 40),
                                     ("expand", 34, 3, 162)):
            assert (tb.block_smem_bytes(kind, c, c_in, k0, span)
                    == lib.vp3d_block_smem_bytes(tb._VARIANT[kind], c, c_in, k0, span))


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


def _stream_setup(c, fw, b, device, seed=0):
    """A random causal model quantized on the card, its bf16 fused weights, and
    seeded first frames."""
    from videopose3d_torch.models.temporal import receptive_field
    from videopose3d_torch.streaming import prepare_stream_weights
    cfg, model, q, _ = _int8_model(c, fw, True, 20, device, seed=seed)
    import dataclasses
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    weights = prepare_stream_weights(bcfg, model)
    g = torch.Generator().manual_seed(seed)
    first = torch.randn(b, 17, 2, generator=g).to(device)
    frames = torch.randn(b, max(receptive_field(cfg), 40), 17, 2, generator=g).to(device)
    return cfg, bcfg, model, q, weights, first, frames


def _clone(ss):
    return {"bufs": [r.clone() for r in ss["bufs"]], "ptr": list(ss["ptr"])}


STREAM_CASES = [  # channels, filter widths, streams, frames per step
    (64, (3, 3, 3), 5, 1),
    (64, (3, 3, 3), 5, 4),      # lag 3 < 4: taps read the step's own frames
    (128, (3, 5, 5), 17, 1),    # 5 taps; 17 streams: a ragged tile of 16
    (64, (3, 3, 3, 3), 3, 8),   # lags 6 and 3 < 8
    (1040, (3, 3, 3), 2, 2),    # two column passes (C > 1024)
]


@pytest.mark.parametrize("c,fw,b,k", STREAM_CASES)
def test_stream_int8_kernel_matches_plain(cuda, c, fw, b, k):
    """The fused int8 engine (K5 / K6) against the per-layer plain engine from
    one state through ring wraps: rings bitwise at every step."""
    from videopose3d_torch import streaming as st
    cfg, _, _, q, _, first, frames = _stream_setup(c, fw, b, cuda)
    if k == 1:
        fused, plain, key = st.stream_step_int8_fused, st.stream_step_int8, "stream_int8"
        a = st.init_stream_state_int8(cfg, q, first)
    else:
        fused, plain = st.stream_step_int8_multi_fused, st.stream_step_int8_multi
        key = "stream_int8_multi"
        a = st.init_stream_state_int8_multi(cfg, q, first, k)
    p = _clone(a)
    for t in range(0, frames.shape[1] - k + 1, k):
        x = frames[:, t] if k == 1 else frames[:, t:t + k]
        before = sf.LAUNCHES[key]
        got, a = fused(cfg, q, a, x)
        assert sf.LAUNCHES[key] == before + 1
        want, p = plain(cfg, q, p, x)
        _check(got, want, torch.float32)
        assert a["ptr"] == p["ptr"]
        for i, (ra, rp) in enumerate(zip(a["bufs"], p["bufs"])):
            assert torch.equal(ra, rp), (t, i)


@pytest.mark.parametrize("c,fw,b,k", STREAM_CASES)
def test_stream_bf16_kernel_matches_plain(cuda, c, fw, b, k):
    """The fused bf16 engine (K5 / K6), each step from the plain engine's state:
    poses and the pushed ring rows at the bf16 bound."""
    from videopose3d_torch import streaming as st
    _, bcfg, model, _, w, first, frames = _stream_setup(c, fw, b, cuda, seed=1)
    if k == 1:
        fused, plain, key = st.stream_step_bf16_fused, st.stream_step, "stream_bf16"
        p = st.init_stream_state(bcfg, model, first)
    else:
        fused, plain = st.stream_step_bf16_multi_fused, st.stream_step_multi
        key = "stream_bf16_multi"
        p = st.init_stream_state_multi(bcfg, model, first, k)
    for t in range(0, frames.shape[1] - k + 1, k):
        x = frames[:, t] if k == 1 else frames[:, t:t + k]
        before = sf.LAUNCHES[key]
        got, a = fused(bcfg, w, _clone(p), x)
        assert sf.LAUNCHES[key] == before + 1
        want, p = plain(bcfg, w, p, x)
        _check(got, want, torch.bfloat16)
        for ra, rp in zip(a["bufs"], p["bufs"]):
            _check(ra, rp, torch.bfloat16)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32, torch.int8])
def test_ring_push_kernel_matches_plain(cuda, dt):
    g = torch.Generator().manual_seed(3)
    buf = (torch.randn(19, 33, 64, generator=g) * 50).to(cuda, dt)
    row = (torch.randn(33, 64, generator=g) * 50).to(cuda, dt)
    for slot in (0, 7, 18):
        want = sf.ring_push_plain(buf.clone(), slot, row)
        before = sf.LAUNCHES["ring_push"]
        got = sf.ring_push(buf.clone(), slot, row)
        assert sf.LAUNCHES["ring_push"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_stream_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from videopose3d_torch import streaming as st
    cfg, _, _, q, _, first, frames = _stream_setup(64, (3, 3, 3), 2, cuda)
    ss = st.init_stream_state_int8_multi(cfg, q, first, 2)
    eq = torch.zeros(2, 2, 64, dtype=torch.int8, device=cuda)
    rings = ss["bufs"][1:]
    kw = dict(widths=(3, 3), lags=[[6, 3], [18, 9]], caps=[rings[0].shape[0] // 2,
                                                           rings[1].shape[0] // 2], k=2)
    with pytest.raises(ValueError, match="dtype"):
        sf.fused_blocks_step_multi(q, rings, eq.float(), [0] * 6, **kw)
    with pytest.raises(ValueError, match="out of range"):
        sf.fused_blocks_step_multi(q, rings, eq, [0, 0, 0, 0, 0, 10 ** 6], **kw)
    with pytest.raises(ValueError, match="1 to 16 frames"):
        sf.fused_blocks_step_multi(q, rings, torch.zeros(17, 2, 64, dtype=torch.int8,
                                                         device=cuda), [0] * 6,
                                   **{**kw, "k": 17})
    with pytest.raises(ValueError, match="16-byte"):
        sf.ring_push(torch.zeros(3, 1, 3, device=cuda), 0, torch.zeros(1, 3, device=cuda))


def test_streaming_lifter_engines_on_card(cuda):
    """The lifter on the card: int8_fused within the float32 bound of int8 (equal
    int8 streams, the shrink's float32 sums in another order), bf16_fused within
    the bf16 bound of bf16, float32 within the float32 bound of the offline
    causal model, and the dma ring write equal to the plain write."""
    import dataclasses
    from videopose3d_torch import streaming as st
    from videopose3d_torch.evaluate import full_float32
    from videopose3d_torch.models.temporal import forward_dilated, receptive_field
    cfg, bcfg, model, q, _, _, frames = _stream_setup(64, (3, 3, 3), 4, cuda, seed=2)
    seq = frames.cpu().numpy()
    streams = [seq[i] for i in range(seq.shape[0])]
    run = lambda c, **kw: np.stack(st.stream_archive(
        c, st.StreamingCausalLifter(c, model, device=cuda, **kw), streams))
    int8 = run(cfg, engine="int8", quantized=q)
    _check(torch.from_numpy(run(cfg, engine="int8_fused", quantized=q)),
           torch.from_numpy(int8), torch.float32)
    bf16 = run(bcfg, engine="bf16")
    assert np.array_equal(run(bcfg, engine="bf16", ring_impl="dma"), bf16)
    _check(torch.from_numpy(run(bcfg, engine="bf16_fused")), torch.from_numpy(bf16),
           torch.bfloat16)
    pad = receptive_field(cfg) - 1
    padded = torch.cat([frames[:, :1].expand(-1, pad, -1, -1), frames], dim=1)
    with full_float32():
        want = forward_dilated(model, padded)
    f32 = run(dataclasses.replace(cfg, compute_dtype="float32"))
    _check(torch.from_numpy(f32).to(cuda), want, torch.float32)
