"""The CUDA kernels against their plain PyTorch versions, on the card: the fused
evaluation blocks (K3), the window gather (K1), the train block with its
backward (K2), the int8 serving stages (K4, with the accshift tap mode K8), and
the streaming step (K5 per frame, K6 k frames; int8 and bf16) with the ring
push (K7), the streaming front (F) and the lifter's CUDA graph of the per-frame
int8 step (poses and rings bitwise against the eager step); the four evaluation
protocols of a video (float64, against the host protocols on float64 copies to
1e-9 relative, bitwise on a second call) and ``evaluate()`` on the card against
the host path over the same poses.

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
from videopose3d_torch.ops.kernels import protocols as pk
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


def _padded(kind, dt, x, p):
    """A stage's kernel operands at whole 16-byte words of ``dt``, padded as
    forward_dilated_fused pads them (channels, keypoint columns, the shrink's
    outputs), and the width its output is cut back to."""
    c = p["w2"].shape[0]
    cp = tb.whole_words(c, dt)
    blk = tb.padded_block(cp, p["w_taps"], *p["bn1"], p["w2"], *p["bn2"])
    if kind == "expand":
        ci = tb.whole_words(x.shape[-1], dt)
        return (tb.pad(x.to(dt), ci), tb.pad(p["w0"], ci, cp), tb.pad(p["bn0"][0], cp),
                tb.pad(p["bn0"][1], cp), *blk), c
    if kind == "shrink":
        j3 = p["ws"].shape[1]
        jp = tb.whole_words(j3, dt)
        return (tb.pad(x, cp), *blk, tb.pad(p["ws"], cp, jp), tb.pad(p["bs"], jp)), j3
    return (tb.pad(x, cp), *blk), c


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
    padded, width = _padded("dilated", dt, x, p)
    before = tb.LAUNCHES["dilated"]
    got = tb.fused_dilated_block(*padded, dilation=d, causal_shift=shift)[..., :width]
    assert tb.LAUNCHES["dilated"] == before + 1
    _check(got, tb.fused_dilated_block_plain(*args, dilation=d, causal_shift=shift), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d,t,shift", CASES)
def test_expand_block_kernel_matches_plain(cuda, dt, c, d, t, shift):
    p = _inputs(c + d + 1, c, dt, cuda)
    x = torch.rand(2, t + 2, 34, generator=torch.Generator().manual_seed(2)).to(cuda) * 2 - 1
    args = (x, p["w0"], *p["bn0"], p["w_taps"], *p["bn1"], p["w2"], *p["bn2"])
    padded, width = _padded("expand", dt, x, p)
    before = tb.LAUNCHES["expand"]
    got = tb.fused_expand_block(*padded, dilation=d, causal_shift=shift)[..., :width]
    assert tb.LAUNCHES["expand"] == before + 1
    _check(got, tb.fused_expand_block_plain(*args, dilation=d, causal_shift=shift), dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,d,t,shift", CASES)
def test_shrink_block_kernel_matches_plain(cuda, dt, c, d, t, shift):
    p = _inputs(c + d + 2, c, dt, cuda)
    x = torch.randn(2, t, c, generator=torch.Generator().manual_seed(3)).to(cuda, dt)
    args = (x, p["w_taps"], *p["bn1"], p["w2"], *p["bn2"], p["ws"], p["bs"])
    padded, width = _padded("shrink", dt, x, p)
    before = tb.LAUNCHES["shrink"]
    got = tb.fused_shrink_block(*padded, dilation=d, causal_shift=shift)[..., :width]
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
    # The kernel copies whole 16-byte words of a row: 6 channels, 34 keypoint
    # columns and 51 shrink outputs are refused (forward_dilated_fused pads them).
    six = (torch.randn(1, 20, 6, device=cuda), torch.randn(3, 6, 6, device=cuda),
           *[torch.ones(6, device=cuda)] * 2, torch.randn(6, 6, device=cuda),
           *[torch.ones(6, device=cuda)] * 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        tb.fused_dilated_block(*six, dilation=1)
    with pytest.raises(ValueError, match="input columns"):
        tb.fused_expand_block(torch.randn(2, 40, 34, device=cuda),
                              torch.randn(3, 34, 64, device=cuda), *p["bn0"], p["w_taps"],
                              *p["bn1"], p["w2"], *p["bn2"], dilation=1)
    blk = (p["w_taps"], *p["bn1"], p["w2"], *p["bn2"])
    with pytest.raises(ValueError, match="output columns"):
        tb.fused_shrink_block(x, *blk, p["ws"], p["bs"], dilation=1)
    # The projection's width is the bias's: a w_shrink of other columns is refused.
    for cols in (48, 56):
        with pytest.raises(ValueError, match="w_shrink has shape"):
            tb.fused_shrink_block(x, *blk, torch.randn(64, cols, device=cuda),
                                  torch.zeros(52, device=cuda), dilation=1)


WIDTHS = [  # channels, frames: any width, as the JAX package's
    (30, 300), (1000, 400), (2048, 300), (3636, 250)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,t", WIDTHS)
def test_stage_kernels_at_any_width(cuda, dt, c, t):
    """Every stage at widths off the 16-byte word (30; 3,636 in bf16), wider than
    a per-channel shared-memory tile could hold (2,048, 3,636) and at 1,000,
    against its plain version; two launches bitwise equal."""
    p = _inputs(c + 7, c, dt, cuda)
    gen = torch.Generator().manual_seed(c)
    raw = (torch.rand(2, t + 2, 34, generator=gen) * 2 - 1).to(cuda)
    x = torch.randn(2, t, c, generator=gen).to(cuda, dt)
    blk = (p["w_taps"], *p["bn1"], p["w2"], *p["bn2"])
    stages = [
        ("expand", raw, (raw, p["w0"], *p["bn0"], *blk), dict(dilation=3),
         tb.fused_expand_block, tb.fused_expand_block_plain),
        ("dilated", x, (x, *blk), dict(dilation=9), tb.fused_dilated_block,
         tb.fused_dilated_block_plain),
        ("shrink", x, (x, *blk, p["ws"], p["bs"]), dict(dilation=27, causal_shift=27),
         tb.fused_shrink_block, tb.fused_shrink_block_plain)]
    for key, v, args, geo, kernel, plain in stages:
        padded, width = _padded(key, dt, v, p)
        before = tb.LAUNCHES[key]
        got = kernel(*padded, **geo)
        again = kernel(*padded, **geo)
        assert tb.LAUNCHES[key] == before + 2
        assert not got[..., width:].any(), key
        _check(got[..., :width], plain(*args, **geo), dt)
        assert torch.equal(got, again), key


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("fw,causal", [
    ((3,), False), ((3, 3), True), ((3, 3, 3), False), ((3, 3, 3, 3), True),
    ((3, 3, 3, 3, 3), False)])
@pytest.mark.parametrize("channels", [64, 30])
def test_fused_forward_matches_plain_forward(cuda, dt, fw, causal, channels):
    """The whole fused forward on the card (0-, 1- and multi-block stacks; 30
    channels run padded to 32) against the plain float32 model on the same
    weights."""
    from videopose3d_torch.models.temporal import (
        TemporalModel, TemporalModelConfig, forward_dilated, forward_dilated_fused,
        receptive_field)
    torch.manual_seed(0)
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=fw, causal=causal, channels=channels,
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
    (300_000, 34, 244, 512, None),    # dilated training: --stride 2 chunks at RF 243
    (60_000, 30, 27, 128, None),      # HumanEva's 15 joints: 120-byte float32 rows
    (60_000, 30, 244, 512, None),
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
    (4096, 34, 244, None),         # the dilated form's --stride 2 windows
    (4096, 30, 27, None),          # HumanEva rows: 120 bytes, 8 (mod 16) in float32
])
def test_gather_kernel_at_every_16_byte_phase(cuda, dt, rows, cols, window, out_cols):
    """Window starts of both parities at even and odd batch indices: a float32
    window of 34 columns then starts at 0 or 8 (mod 16) in the stream and, for
    an odd window, in the output, in all four pairs, and the copy is bitwise
    equal at each."""
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
        # An even window spans whole 16-byte words: every output window starts at 0.
        out_phases = (0, 8) if span % 16 else (0,)
        assert phases == {(s, o) for s in (0, 8) for o in out_phases}


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
    # 3,636 channels run: every train-block kernel is a tap GEMM or elementwise,
    # with nothing per channel in shared memory.
    c = 3636
    assert trb.channel_limit_error(c) is None
    p = _tap_inputs(4, c, 1, torch.float32, False, cuda)
    args = (p["ga"], p["u"], p["g"], p["coef"], p["wa"])
    got = trb.du_dtaps_res(*args, center=0)
    for a, w in zip(got, trb.du_dtaps_res_plain(*args, center=0)):
        _check(a, w, torch.float32)
    args = (p["ga"], p["u"], p["coef"], p["wa"][0])
    for a, w in zip(trb.dz_matmul_dd(*args), trb.dz_matmul_dd_plain(*args)):
        _check(a, w, torch.float32)


def test_width_mirrors_equal_the_kernels_own(cuda):
    """The pure-Python shared-memory formulas and limits that refuse a width
    before any data loads equal the ones the CUDA sources report: the opt-in
    ceiling and the streaming step (K5, K6); and the train block's geometry that
    sizes its partial sums and relu_mask_bn_sums's plan."""
    from videopose3d_torch.ops.kernels.build import load_library
    lib = load_library()
    assert tb.SMEM_OPT_IN == lib.vp3d_block_max_smem_bytes()
    assert [lib.vp3d_tb_geometry(i) for i in range(5)] == [
        trb.DW_TILE, trb.SUM_COLS, trb.SUM_SLOTS, trb.SUM_UNROLL, trb.SUM_MAX_CLUSTER]
    assert (sf.MAX_BLOCKS, sf.MAX_TAPS) == (lib.vp3d_stream_max_blocks(),
                                            lib.vp3d_stream_max_taps())
    for c in (4, 16, 68, 1024, 1028, 2064, 3632, 3636, sf.INT8_MAX_CHANNELS,
              sf.INT8_MAX_CHANNELS + 1):
        for int8 in (True, False):
            assert sf.step_smem_bytes(int8, c) == lib.vp3d_stream_smem_bytes(int(not int8), c)


# The grid of the step's plans: widths (the int8 step's ceiling too), stream counts
# and frames per step, on this card's SM count and 132.
PLAN_WIDTHS = {"int8": (1, 8, 30, 64, 200, 1000, 1024, 2080, 4096, 8192,
                        sf.INT8_MAX_CHANNELS),
               "bf16": (1, 8, 30, 64, 200, 1024, 1216, 2048, 2360, 4096, 9000,
                        sf.BF16_MAX_CHANNELS)}
PLAN_STREAMS, PLAN_FRAMES = (1, 2, 5, 17, 256, 1000, 1024, 4096), (1, 2, 3, 8, 16)


def _plan_weights(kind, c, device):
    """Seeded weights of a one-block step of filter width 2 at ``c`` channels (as
    kernel_ab.py's stream steps make them), the kind's fused-step weights."""
    gen = torch.Generator(device).manual_seed(c)
    ws = (torch.randn(c, 8, device=device, generator=gen) * c ** -0.5).to(torch.bfloat16)
    bs = torch.randn(8, device=device, generator=gen) * 0.1
    if kind == "int8":
        i8 = lambda *shape: torch.randint(-127, 128, shape, device=device, generator=gen,
                                          dtype=torch.int8)
        vec = lambda scale, shift: ((torch.rand(c, device=device, generator=gen) + 0.5)
                                    * scale + shift * torch.randn(c, device=device,
                                                                  generator=gen))
        blk = tq.Int8Block(i8(2, c, c), i8(c, c), vec(1 / (127 * (2 * c) ** 0.5), 0),
                           vec(0, 0.5), vec(1 / (127 * c ** 0.5), 0), vec(0, 0.5),
                           vec(0.5, 0))
        return sf.Int8StepWeights.of(tq.QuantizedModel(None, None, None, [blk], ws, bs))
    bf = lambda *shape, scale: (torch.randn(shape, device=device, generator=gen)
                                * scale).to(torch.bfloat16)
    vecs = torch.stack([torch.rand(c, device=device, generator=gen) + 0.5,
                        torch.randn(c, device=device, generator=gen) * 0.1] * 2)
    return {"w1": [bf(2, c, c, scale=(2 * c) ** -0.5)], "w2": [bf(c, c, scale=c ** -0.5)],
            "vecs": [vecs], "shrink_w": ws, "shrink_b": bs}


def _plan_step(kind, w, k, device):
    """The fused step (K5, or K6 at k > 1) on weights ``w`` of :func:`_plan_weights`
    and one stream, its plain version, and seeded rings (doubled at k > 1): each
    step a function of the rings, returning (poses, rings)."""
    c = (w.q.blocks[0].wq_b if kind == "int8" else w["w2"][0]).shape[0]
    gen = torch.Generator(device).manual_seed(c * 17 + k)
    cap = 2 * k
    idx = [0, cap - 1]  # write at 0; the tap one frame back
    shape = ((2 if k > 1 else 1) * cap, 1, c)
    if kind == "int8":
        rings = [torch.randint(0, 128, shape, device=device, generator=gen,
                               dtype=torch.int8)]
        x = torch.randint(0, 128, (k, 1, c), device=device, generator=gen, dtype=torch.int8)
        fns = ((sf.fused_blocks_step, sf.fused_blocks_step_plain) if k == 1 else
               (sf.fused_blocks_step_multi, sf.fused_blocks_step_multi_plain))
    else:
        rings = [torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)]
        x = torch.rand(k, 1, c, device=device, generator=gen)
        fns = ((sf.fused_blocks_step_bf16, sf.fused_blocks_step_bf16_plain) if k == 1 else
               (sf.fused_blocks_step_bf16_multi, sf.fused_blocks_step_bf16_multi_plain))
    if k == 1:
        run = lambda fn, r: fn(w, r, x[0], idx, widths=(2,))
    else:
        run = lambda fn, r: fn(w, r, x, idx, widths=(2,), lags=[[1]], caps=[cap], k=k)
    return (lambda r: run(fns[0], r)), (lambda r: run(fns[1], r)), rings


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_every_planned_stream_plan_launches(cuda, kind, monkeypatch):
    """Every plan (rows per CUDA block, column slices per cluster) the Python
    planner picks over the grid of widths, stream counts and frames per step, on
    this card's SM count and 132, launches on one stream and gives the plain
    version's poses and rings (int8 rings bitwise; bf16 at its bound): the C side
    only checks the plan it is given, and whether a plan fits does not depend on
    the stream count.  The plans' shared memory, pure Python, equals the kernel's
    own (past the ceiling too)."""
    from videopose3d_torch.ops.kernels.build import load_library
    lib_smem = getattr(load_library(), f"vp3d_stream_{kind}_smem")
    plan_fn = getattr(sf, f"stream_{kind}_plan")
    smem = getattr(sf, f"{kind}_smem_bytes")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for c in PLAN_WIDTHS[kind] + (PLAN_WIDTHS[kind][-1] + 1,):
        for rows in sf.TC_ROWS:
            for slices in (1, 2, 4, 8):
                assert smem(rows, slices, c) == lib_smem(rows, slices, c), (rows, slices, c)
    for c in PLAN_WIDTHS[kind]:
        w = _plan_weights(kind, c, cuda)
        for k in PLAN_FRAMES:
            plans = {plan_fn(b, k, c, n_sms) for b in PLAN_STREAMS for n_sms in {sms, 132}}
            assert None not in plans, (c, k)
            kernel, plain, rings = _plan_step(kind, w, k, cuda)
            for plan in sorted(plans):
                assert smem(*plan, c) <= tb.SMEM_OPT_IN, (c, k, plan)
                monkeypatch.setattr(sf, f"stream_{kind}_plan", lambda *_, p=plan: p)
                want_rings = [r.clone() for r in rings]
                got_rings = [r.clone() for r in rings]
                want, _ = plain(want_rings)
                got, _ = kernel(got_rings)
                where = (c, k, plan)
                if kind == "int8":
                    assert torch.equal(got_rings[0], want_rings[0]), where
                    _check(got, want, torch.float32)
                else:
                    _check(got, want, torch.bfloat16)
                    _check(got_rings[0], want_rings[0], torch.bfloat16)
            monkeypatch.setattr(sf, f"stream_{kind}_plan", plan_fn)
        del w
    assert plan_fn(1, 1, PLAN_WIDTHS[kind][-1] + 1, sms) is None


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_stream_step_refuses_a_plan_it_cannot_take(cuda, kind, monkeypatch):
    """A plan that breaks plan_fits (rows not a multiple of 16, past 80 or fewer
    than the step's frames; slices not a power of two or past the width's most; a
    block's shared memory past the opt-in ceiling) is refused by the C side with
    cudaErrorInvalidValue: the launch raises naming the kernel, counts nothing and
    leaves the rings as they were."""
    top = getattr(sf, f"{kind.upper()}_MAX_CHANNELS")
    cases = [(64, 1, (24, 1)), (64, 8, (96, 1)), (64, 1, (0, 1)), (64, 1, (16, 0)),
             (1024, 1, (16, 3)), (8, 4, (16, 2)), (1024, 1, (16, 16)), (top, 1, (80, 1))]
    key = f"stream_{kind}"
    for c, k, plan in cases:
        kernel, _, rings = _plan_step(kind, _plan_weights(kind, c, cuda), k, cuda)
        before_rings = [r.clone() for r in rings]
        monkeypatch.setattr(sf, f"{key}_plan", lambda *_, p=plan: p)
        before = dict(sf.LAUNCHES)
        with pytest.raises(RuntimeError, match=f"the {key}(_multi)? kernel failed to "
                                               "launch: invalid argument"):
            kernel(rings)
        torch.cuda.synchronize()
        assert sf.LAUNCHES == before, (c, k, plan)
        assert torch.equal(rings[0], before_rings[0]), (c, k, plan)


def _one_tap_inputs(n, c, dt, dropout, device):
    """Seeded inputs of norm_drop_matmul_stats and dz_matmul_dd: activations, a
    dropout mask (or None), BatchNorm constants and the (C, C) weights."""
    gen = torch.Generator(device).manual_seed(n * 5 + c)
    f = lambda *shape, scale=1.0: (torch.randn(*shape, device=device, generator=gen)
                                   * scale).to(dt)
    mask = ((torch.rand(n, c, device=device, generator=gen) < 0.75) / 0.75).to(dt)
    gate = torch.stack([torch.randn(c, device=device, generator=gen) * 0.1,
                        torch.rand(c, device=device, generator=gen) + 0.5,
                        torch.randn(c, device=device, generator=gen) * 0.2]).to(dt)
    coef = torch.stack([torch.rand(c, device=device, generator=gen) + 0.5,
                        torch.randn(c, device=device, generator=gen) * 0.1,
                        torch.randn(c, device=device, generator=gen) * 0.1,
                        torch.rand(c, device=device, generator=gen) + 0.5,
                        torch.randn(c, device=device, generator=gen) * 0.1])
    return dict(u=f(n, c), mask=mask if dropout else None, gate=gate, coef=coef,
                wb=f(c, c, scale=1 / np.sqrt(c)), g=f(n, c),
                shift=torch.randn(c, device=device, generator=gen) * 0.1)


ONE_TAP_C = [68, 1024, 1028, 3636]


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", ONE_TAP_C)
@pytest.mark.parametrize("n", [1, 31, 129, 1024, 27_648])
def test_norm_drop_matmul_stats_kernel_matches_plain(cuda, n, c, dt, dropout):
    """d = mask * relu(bn(u)), then the one-tap GEMM v = d @ Wb with conv_stats's
    BatchNorm partial sums (ragged row and column tiles, slabs and summed-dimension
    slices): within tolerance of the plain version, one launch counted per call,
    and two launches bitwise equal."""
    p = _one_tap_inputs(n, c, dt, dropout, cuda)
    args = (p["u"], p["mask"], p["gate"], p["wb"], p["shift"])
    before = trb.LAUNCHES["norm_drop_matmul_stats"]
    got = trb.norm_drop_matmul_stats(*args)
    assert trb.LAUNCHES["norm_drop_matmul_stats"] == before + 1
    again = trb.norm_drop_matmul_stats(*args)
    assert trb.LAUNCHES["norm_drop_matmul_stats"] == before + 2
    want = trb.norm_drop_matmul_stats_plain(*args)
    for a, w in zip(got, want):
        _check(a, w, dt)
    assert torch.equal(got[0], want[0])  # d: the same operations in T
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", ONE_TAP_C)
@pytest.mark.parametrize("n", [1, 31, 129, 1024, 27_648])
def test_dz_matmul_dd_kernel_matches_plain(cuda, n, c, dt, dropout):
    """dz = the BatchNorm input gradient of gz (a quarter of it zero with
    dropout, as behind the gate's mask), then the one-tap GEMM dd = dz @ Wb^T:
    within tolerance of the plain version, one launch counted per call, and two
    launches bitwise equal."""
    p = _one_tap_inputs(n, c, dt, dropout, cuda)
    gz = p["g"] if p["mask"] is None else p["g"] * p["mask"]
    args = (gz, p["u"], p["coef"], p["wb"])
    before = trb.LAUNCHES["dz_matmul_dd"]
    got = trb.dz_matmul_dd(*args)
    assert trb.LAUNCHES["dz_matmul_dd"] == before + 1
    again = trb.dz_matmul_dd(*args)
    assert trb.LAUNCHES["dz_matmul_dd"] == before + 2
    want = trb.dz_matmul_dd_plain(*args)
    for a, w in zip(got, want):
        _check(a, w, dt)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _relu_sums_args(n, c, dt, dropout, device):
    """Seeded (g, z, mask, stat, gate) of relu_mask_bn_sums: stat rows [mean,
    inv] float32, gate rows [mean, inv, bias] in dt (about half the gate open)."""
    p = _one_tap_inputs(n, c, dt, dropout, device)
    gen = torch.Generator(device).manual_seed(n * 7 + c)
    stat = torch.stack([torch.randn(c, device=device, generator=gen) * 0.1,
                        torch.rand(c, device=device, generator=gen) + 0.5])
    return p["g"], p["u"], p["mask"], stat, p["gate"]


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4, 68, 1024, 1028, 3636])
@pytest.mark.parametrize("n", [1, 31, 1000, 1024, 3072, 9216, 27_648, 27_649])
def test_relu_mask_bn_sums_kernel_matches_plain(cuda, n, c, dt, dropout):
    """The backward's gate with the BatchNorm sums, one clustered launch: gz
    bitwise equal to the plain version (the same operations in T), both float32
    sums within tolerance (another summation order), one launch counted per
    call, and two launches bitwise equal, at ragged n (1,000 and 27,649 rows
    fill no whole slice of slots), ragged strips (C = 4, 68, 1,028, 3,636) and
    every cluster size the plan picks (up to 16)."""
    args = _relu_sums_args(n, c, dt, dropout, cuda)
    before = trb.LAUNCHES["relu_mask_bn_sums"]
    got = trb.relu_mask_bn_sums(*args)
    again = trb.relu_mask_bn_sums(*args)
    assert trb.LAUNCHES["relu_mask_bn_sums"] == before + 2
    want = trb.relu_mask_bn_sums_plain(*args)
    for a, w in zip(got, want):
        _check(a, w, dt)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_relu_mask_bn_sums_graph_replays_bitwise(cuda):
    """Captured once in a CUDA graph at the first residual block's shape and
    replayed twice: both replays bitwise equal to each other and to an eager
    launch (no state survives a launch)."""
    args = _relu_sums_args(27_648, 1024, torch.float32, True, cuda)
    eager = trb.relu_mask_bn_sums(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        trb.relu_mask_bn_sums(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trb.relu_mask_bn_sums(*args)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in out])
    for a, b, e in zip(*replays, eager):
        assert torch.equal(a, b) and torch.equal(a, e)


def test_relu_mask_bn_sums_refuses_misaligned_rows(cuda):
    """Rows of whole 16-byte words (float32) or the wrapper raises; stat too.
    bf16 rows need whole 8-byte words only: 8-byte aligned rows run and agree."""
    args = list(_relu_sums_args(1024, 1024, torch.bfloat16, True, cuda))
    flat = torch.zeros(1024 * 1024 + 4, device=cuda, dtype=torch.bfloat16)
    args[1] = flat[4:].view(1024, 1024).copy_(args[1])
    got, want = trb.relu_mask_bn_sums(*args), trb.relu_mask_bn_sums_plain(*args)
    for a, w in zip(got, want):
        _check(a, w, torch.bfloat16)
    assert torch.equal(got[0], want[0])
    g, z, mask, stat, gate = _relu_sums_args(16, 64, torch.float32, True, cuda)
    flat = torch.randn(16 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        trb.relu_mask_bn_sums(flat[1:].view(16, 64), z, mask, stat, gate)
    flat = torch.randn(2 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        trb.relu_mask_bn_sums(g, z, mask, flat[1:].view(2, 64), gate)
    with pytest.raises(ValueError, match="multiple of 4"):
        trb.relu_mask_bn_sums(g[:, :6].contiguous(), z[:, :6].contiguous(),
                              mask[:, :6].contiguous(), stat[:, :6].contiguous(),
                              gate[:, :6].contiguous())


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
    (8, 9, 30, 3, 1, True),          # C % 4 != 0: padded to 32 zero channels
    # Semi-supervised -arc 3,3,3 -b 64 at full width: the blocks in warmup (n = 192
    # and 64) and after it on the doubled batch (n = 384 and 128): partial 128-row
    # tiles and one-slab slices.
    (64, 9, 1024, 3, 1, True),
    (64, 3, 1024, 3, 1, True),
    (128, 9, 1024, 3, 1, True),
    (128, 3, 1024, 3, 1, True),
]


@pytest.mark.parametrize("n", [64, 128, 192, 384, 2048, 6144, 18_432, 55_296])
def test_train_block_plans_tile_the_rows_on_this_card(cuda, n):
    """At the semi-supervised steps' row counts and this card's SM count, each
    K2 plan cuts its dimension into in-order slices that tile it exactly."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = [trb.relu_sums_plan(n, 1024, 4), trb.relu_sums_plan(n, 1024, 2),
             trb.dw_gemm_plan(n, 1024, 1024, sms), trb.dw_gemm_plan(n, 3072, 1024, sms),
             trb.tap_gemm_plan(n, 3072, 1024, sms), trb.tap_gemm_plan(n, 1024, 3072, sms),
             trb.tap_gemm_plan(n, 1024, 1024, sms)]
    for plan, length in zip(plans, (n, n, n, n, 3072, 1024, 1024)):
        assert plan[0][0] == 0 and plan[-1][1] == length
        assert all(a < b for a, b in plan)
        assert all(stop == start for (_, stop), (start, _) in zip(plan, plan[1:]))


@pytest.mark.parametrize("b,t,c,fw,center,dropout", TRAIN_BLOCK_CASES)
def test_train_block_kernels_match_plain(cuda, b, t, c, fw, center, dropout):
    """float32: out, both stat pairs and every gradient within 1e-4 of the
    plain versions (float32 sums in other orders), all seven kernels launched
    (dw_gemm twice: dWb and dWa)."""
    p = _train_block_inputs(b * c + fw, b, t, c, fw, torch.float32, dropout, cuda)
    before = dict(trb.LAUNCHES)
    got = _block_run(p, fw, center, plain=False)
    launched = {k: trb.LAUNCHES[k] - before[k] for k in before}
    assert launched == {**{k: 1 for k in launched}, "relu_mask_bn_sums": 2, "dw_gemm": 2}
    want = _block_run(p, fw, center, plain=True)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        _check(a, w, torch.float32)


def _product_operands(name, n, c, device):
    """Seeded float32 operands (a, b) of one K2 product at n rows of C channels,
    the kernel's call on them, and the product as float64 and as one
    ``torch.matmul`` in float32: the four tap GEMMs (the product alone: no
    residual cotangent, BatchNorm coefficients that pass du through) and both
    weight gradients."""
    gen = torch.Generator(device).manual_seed(n + len(name))
    f = lambda *shape, scale=1.0: torch.randn(*shape, device=device, generator=gen) * scale
    ones, zeros = torch.ones(c, device=device), torch.zeros(c, device=device)
    coef = torch.stack([ones, zeros, zeros, ones, zeros])  # bn input gradient = gz
    gate = torch.stack([zeros, ones, zeros])  # d = relu(u)
    wa = f(3, c, c, scale=(3 * c) ** -0.5)
    if name == "conv_stats":
        x3 = f(n, 3, c)
        a, b = x3.reshape(n, 3 * c), wa.reshape(3 * c, c)
        kernel = lambda: trb.conv_stats(x3, wa, zeros, center=1)[0]
    elif name == "du_dtaps_res":
        ga = f(n, c)
        a, b = ga, wa.permute(2, 0, 1).reshape(c, 3 * c).contiguous()
        kernel = lambda: trb.du_dtaps_res(ga, ga, torch.zeros_like(ga), coef, wa,
                                          center=1)[1].reshape(n, 3 * c)
    elif name == "norm_drop_matmul_stats":
        u = f(n, c)
        a, b = torch.relu(u), wa[0].contiguous()
        kernel = lambda: trb.norm_drop_matmul_stats(u, None, gate, b, zeros)[1]
    elif name == "dz_matmul_dd":
        gz = f(n, c)
        a, b = gz, wa[0].t().contiguous()
        kernel = lambda: trb.dz_matmul_dd(gz, gz, coef, wa[0])[1]
    else:  # dWb = d^T dz, dWa = x3^T du (n rows of fw C)
        rows, b = f(n, 3 * c if name == "dwa" else c), f(n, c)
        kernel = lambda: trb.dw_gemm(rows, b)
        a = rows.t()
    return kernel, (a.double() @ b.double()), lambda: torch.matmul(a, b)


@pytest.mark.parametrize("name", ["conv_stats", "du_dtaps_res", "norm_drop_matmul_stats",
                                  "dz_matmul_dd", "dwb", "dwa"])
@pytest.mark.parametrize("n", [27_648, 3072])
def test_k2_products_keep_float32_accuracy(cuda, n, name):
    """Each float32 K2 product (3xTF32 on the tensor cores) against float64: no
    more than 4x the max error of a float32 ``torch.matmul`` (TF32 off), and
    under 1/8 of a TF32 ``torch.matmul``'s, which a one-pass TF32 product fails."""
    kernel, want, library = _product_operands(name, n, 1024, cuda)
    err = lambda got: float((got.double() - want).abs().max())
    got = kernel()
    assert got.dtype == torch.float32
    fp32 = err(library())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = err(library())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert err(got) <= 4 * fp32, (err(got), fp32, tf32)
    assert err(got) < tf32 / 8, (err(got), fp32, tf32)


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


@pytest.mark.parametrize("c", [30, 3636])
def test_pallas_train_engine_trains_at_any_width(cuda, c):
    """--train-engine pallas at widths the kernels once refused: 30 channels (not
    a multiple of 4, padded) and 3,636 (past the old 16 x C shared-memory tile).
    One training step of a two-block model on the card through the train-block
    kernels gives the loss of the plain xla engine (same weights and dropout
    masks) to 1e-4 relative and its gradients to 1e-2 relative norm (ReLU gates
    that flip between summation orders; chip_smoke.py's GRAD_NORM_TOL), and an
    SGD step on them lowers the loss."""
    import dataclasses

    from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                    forward_strided, receptive_field)
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=(3, 3), dropout=0.25, channels=c)
    torch.manual_seed(3)
    base = TemporalModel(cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, receptive_field(cfg), 17, 2)).astype(np.float32)).to(cuda)
    target = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, 1, 17, 3)).astype(np.float32)).to(cuda)
    results = {}
    for engine in ("xla", "pallas"):
        model = TemporalModel(dataclasses.replace(cfg, train_engine=engine)).to(cuda)
        model.load_state_dict(base.state_dict())
        before = dict(trb.LAUNCHES)
        losses = []
        for _ in range(2):
            model.zero_grad()
            pred = forward_strided(model, x, momentum=0.1,
                                   generator=torch.Generator(cuda).manual_seed(11))
            loss = ((pred - target) ** 2).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            if len(losses) == 1:
                grads = [p.grad.double().clone() for p in model.parameters()]
                with torch.no_grad():
                    for p in model.parameters():
                        p -= 0.01 * p.grad
        launched = {k: trb.LAUNCHES[k] - before[k] for k in before}
        assert all(launched.values()) == (engine == "pallas"), launched
        assert losses[1] < losses[0]
        results[engine] = (losses[0], grads)
    (loss_x, grads_x), (loss_p, grads_p) = results["xla"], results["pallas"]
    assert abs(loss_p - loss_x) <= 1e-4 * abs(loss_x)
    for a, b in zip(grads_p, grads_x):
        assert float((a - b).norm()) <= 1e-2 * max(float(b.norm()), 1e-12)


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
    n, j3 = len(q.blocks), q.shrink_w.shape[1]
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
                   lambda v, m: tq.int8_shrink_block(
                       v, q.blocks[-1], *tq.shrink_operands(q), tap_mode=m,
                       **geo[-1])[..., :j3],
                   lambda v, m: tq.int8_shrink_block_plain(v, q.blocks[-1], q.shrink_w,
                                                           q.shrink_b, tap_mode=m,
                                                           **geo[-1])))
    return stages


INT8_CASES = [  # channels, filter widths, causal, frames past the receptive field
    (64, (3, 3, 3), False, 45),
    (64, (3, 3, 3, 3), True, 19),     # ragged: 20 output rows, causal offsets
    (80, (5, 5, 5), False, 10),       # 5 taps, a channel count below a full warp pass
    (1040, (3, 3, 3), False, 30),     # C % 128 != 0: a ragged last column tile
    (1024, (3, 3, 3, 3, 3), False, 200),
    (1952, (3, 3, 3), False, 12),     # past the first kernel's shared-memory ceiling
    (3636, (3, 3, 3), False, 12),     # run padded to 3,648 channels
]


@pytest.mark.parametrize("c,fw,causal,frames", INT8_CASES)
def test_int8_stage_kernels_match_plain(cuda, c, fw, causal, frames):
    """Each stage's chain against its plain version on the model the forward runs
    (padded to a multiple of 16 channels): mid blocks bitwise, expand within one
    step on <= 1e-3 of its elements, the shrink within the float32 bound; accshift
    bitwise equal to slice, and two launches bitwise equal."""
    cfg, _, q, x = _int8_model(c, fw, causal, frames, cuda, seed=c + len(fw))
    q = tq.channel_padded(q)
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
        assert torch.equal(kernel(v, "slice"), got["slice"]), name
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


@pytest.mark.parametrize("c", [30, 1030, 1952])
def test_int8_forward_at_any_width(cuda, c):
    """A width off the stage kernels' multiple of 16 runs as the zero-padded model
    (32, 1,040 channels), and 1,952 (refused by the first kernel's shared memory)
    as it is: the forward on the card against the plain stage chain of that
    model."""
    from videopose3d_torch.models.temporal import forward_dilated_int8
    cfg, _, q, x = _int8_model(c, (3, 3, 3), False, 30, cuda, seed=c)
    got = forward_dilated_int8(cfg, q, x)
    v = None
    for _, _, first, _, plain in _int8_stages(cfg, tq.channel_padded(q), x):
        v = plain(first if first is not None else v, "slice")
    _check(got, v.reshape(got.shape), torch.float32)


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

# The int8 kernel takes any C up to sf.INT8_MAX_CHANNELS (rows of C % 16 != 0
# bytes, not 16-byte aligned, load element by element; K and N tails zero-filled).
INT8_STREAM_CASES = STREAM_CASES + [
    (30, (3, 3, 3), 5, 1),          # C % 16 != 0, ragged K and N tiles
    (30, (3, 3, 3), 3, 4),
    (1000, (3, 3, 3), 7, 1),        # C % 16 == 8: element-by-element rows
    (2080, (3, 3, 3), 3, 8),        # past the CUDA-core kernel's 2,064 ceiling
    (4096, (3, 3, 3), 2, 1),
    (1024, (3, 3, 3, 3, 3), 1024, 1),   # the full-width model at B = 1,024
    (1024, (3, 3, 3, 3, 3), 1024, 8),
]


@pytest.mark.parametrize("c,fw,b,k", INT8_STREAM_CASES)
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
    w = st.prepare_int8_fused(q)
    p = _clone(a)
    for t in range(0, frames.shape[1] - k + 1, k):
        x = frames[:, t] if k == 1 else frames[:, t:t + k]
        before = sf.LAUNCHES[key]
        got, a = fused(cfg, w, a, x)
        assert sf.LAUNCHES[key] == before + 1
        want, p = plain(cfg, q, p, x)
        _check(got, want, torch.float32)
        assert a["ptr"] == p["ptr"]
        for i, (ra, rp) in enumerate(zip(a["bufs"], p["bufs"])):
            assert torch.equal(ra, rp), (t, i)


def _bf16_stream_setup(c, fw, b, device, seed):
    """A random causal bfloat16 model on the card (random BatchNorm statistics),
    its fused-engine weights and seeded first frames and frames."""
    from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                    receptive_field)
    from videopose3d_torch.streaming import prepare_bf16_fused
    torch.manual_seed(seed)
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=fw, causal=True, channels=c,
                              compute_dtype="bfloat16")
    model = TemporalModel(cfg)
    for bn in [model.expand_bn, *model.layers_bn]:
        bn.running_var.uniform_(0.5, 2.0)
        bn.bias.data.uniform_(-0.2, 0.2)
    model = model.to(device).eval()
    g = torch.Generator().manual_seed(seed)
    first = torch.randn(b, 17, 2, generator=g).to(device)
    frames = torch.randn(b, max(receptive_field(cfg), 40), 17, 2, generator=g).to(device)
    return cfg, model, prepare_bf16_fused(cfg, model), first, frames


# The bf16 kernel takes any C (rows of C % 8 != 0 channels, not 16-byte aligned,
# load element by element), up to sf.BF16_MAX_CHANNELS, and blocks of 1 to 9 taps.
BF16_STREAM_CASES = STREAM_CASES + [
    (30, (3, 3, 3), 5, 1),          # C % 8 != 0, ragged K and N tiles
    (30, (3, 3, 3), 3, 4),
    (64, (3, 9, 3), 5, 1),          # a 9-tap block beside a 3-tap one
    (40, (3, 5, 3), 6, 3),
    (1216, (3, 3, 3), 4, 1),        # past the CUDA-core kernel's 1,200 ceiling
    (2048, (3, 3, 3), 3, 8),
    (4096, (3, 3), 2, 1),
    (1024, (3, 3, 3, 3, 3), 1024, 1),   # the full-width model at B = 1,024
]


@pytest.mark.parametrize("c,fw,b,k", BF16_STREAM_CASES)
def test_stream_bf16_kernel_matches_plain(cuda, c, fw, b, k):
    """The fused bf16 engine (K5 / K6), each step from the plain engine's state:
    poses and the pushed ring rows at the bf16 bound."""
    from videopose3d_torch import streaming as st
    bcfg, model, w, first, frames = _bf16_stream_setup(c, fw, b, cuda, seed=1)
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


@pytest.mark.parametrize("c,fw,b,k", [(64, (3, 3, 3), 5, 1), (1216, (3, 3, 3), 33, 8),
                                      (30, (3, 3, 3), 7, 3)])
def test_stream_bf16_kernel_repeats_bitwise(cuda, c, fw, b, k):
    """Two launches of the bf16 step from one cloned state give equal poses and
    rings: the column slices of a cluster meet through buffers in a fixed order,
    with no atomics."""
    from videopose3d_torch import streaming as st
    bcfg, model, w, first, frames = _bf16_stream_setup(c, fw, b, cuda, seed=3)
    if k == 1:
        step, x = st.stream_step_bf16_fused, frames[:, 0]
        p = st.init_stream_state(bcfg, model, first)
    else:
        step, x = st.stream_step_bf16_multi_fused, frames[:, :k]
        p = st.init_stream_state_multi(bcfg, model, first, k)
    got = [step(bcfg, w, _clone(p), x) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], got[1][0])
    for ra, rb in zip(got[0][1]["bufs"], got[1][1]["bufs"]):
        assert torch.equal(ra, rb)


@pytest.mark.parametrize("c,fw,b,k", [(64, (3, 3, 3), 5, 1), (1000, (3, 3, 3), 33, 8),
                                      (30, (3, 3, 3), 7, 3)])
def test_stream_int8_kernel_repeats_bitwise(cuda, c, fw, b, k):
    """Two launches of the int8 step from one cloned state give equal poses and
    rings: the cluster's slices meet through buffers and shared memory in a fixed
    order, with no atomics."""
    from videopose3d_torch import streaming as st
    cfg, _, _, q, _, first, frames = _stream_setup(c, fw, b, cuda, seed=3)
    if k == 1:
        step, x = st.stream_step_int8_fused, frames[:, 0]
        p = st.init_stream_state_int8(cfg, q, first)
    else:
        step, x = st.stream_step_int8_multi_fused, frames[:, :k]
        p = st.init_stream_state_int8_multi(cfg, q, first, k)
    w = st.prepare_int8_fused(q)
    got = [step(cfg, w, _clone(p), x) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], got[1][0])
    for ra, rb in zip(got[0][1]["bufs"], got[1][1]["bufs"]):
        assert torch.equal(ra, rb)


@pytest.mark.parametrize("dt,b,c", [(torch.bfloat16, 33, 64), (torch.float32, 33, 64),
                                    (torch.int8, 33, 64),
                                    (torch.float32, 1, 30),    # 120-byte rows
                                    (torch.int8, 3, 1000)])    # 3,000-byte rows
def test_ring_push_kernel_matches_plain(cuda, dt, b, c):
    """K7 bitwise against the plain write at the first, a middle and the last slot,
    for rows of whole 16-byte words and rows that are not (any slot offset)."""
    g = torch.Generator().manual_seed(3)
    buf = (torch.randn(19, b, c, generator=g) * 50).to(cuda, dt)
    row = (torch.randn(b, c, generator=g) * 50).to(cuda, dt)
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
    w = st.prepare_int8_fused(q)
    eq = torch.zeros(2, 2, 64, dtype=torch.int8, device=cuda)
    rings = ss["bufs"][1:]
    kw = dict(widths=(3, 3), lags=[[6, 3], [18, 9]], caps=[rings[0].shape[0] // 2,
                                                           rings[1].shape[0] // 2], k=2)
    with pytest.raises(ValueError, match="dtype"):
        sf.fused_blocks_step_multi(w, rings, eq.float(), [0] * 6, **kw)
    with pytest.raises(ValueError, match="out of range"):
        sf.fused_blocks_step_multi(w, rings, eq, [0, 0, 0, 0, 0, 10 ** 6], **kw)
    with pytest.raises(ValueError, match="1 to 16 frames"):
        sf.fused_blocks_step_multi(w, rings, torch.zeros(17, 2, 64, dtype=torch.int8,
                                                         device=cuda), [0] * 6,
                                   **{**kw, "k": 17})
    with pytest.raises(ValueError, match="out of range"):
        sf.ring_push(torch.zeros(3, 1, 3, device=cuda), 3, torch.zeros(1, 3, device=cuda))


def test_streaming_lifter_dma_at_30_channels(cuda):
    """One stream at 30 float32 channels: every block-ring row is 120 bytes, off the
    16-byte word, and ring_impl="dma" (K7) gives the plain write's poses."""
    import dataclasses
    from videopose3d_torch import streaming as st
    cfg, _, model, _, _, _, frames = _stream_setup(30, (3, 3, 3), 1, cuda, seed=4)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    streams = [frames.cpu().numpy()[0]]
    run = lambda **kw: np.stack(st.stream_archive(
        f32, st.StreamingCausalLifter(f32, model, device=cuda, **kw), streams))
    before = sf.LAUNCHES["ring_push"]
    dma = run(ring_impl="dma")
    assert sf.LAUNCHES["ring_push"] > before
    assert np.array_equal(dma, run())


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


# -- the streaming lifter's CUDA graph (int8_fused, k = 1) ----------------------


FRONT_CASES = [  # channels, filter widths, streams
    (1024, (3, 3, 3, 3, 3), 1024),  # the main path's
    (30, (3, 3, 3), 5),             # C % 4 != 0: the expand stores byte by byte
    (1000, (5, 3, 3), 67),          # 5 raw taps; a ragged tile of rows
]


@pytest.mark.parametrize("c,fw,b", FRONT_CASES)
def test_stream_front_and_advance_kernels_match_plain(cuda, c, fw, b):
    """The streaming front (F) bitwise against its plain version, eq and the raw
    ring, at every position of the raw ring through two wraps; the advance kernel
    against its plain version at each step; the positions read, not moved, by F."""
    from videopose3d_torch import streaming as st
    cfg, _, _, q, _, first, frames = _stream_setup(c, fw, b, cuda)
    ss = st.init_stream_state_int8(cfg, q, first)
    caps = st._buffer_capacities(cfg)
    k0, c_in, _ = q.expand_w.shape
    w0 = q.expand_w.reshape(k0 * c_in, c).contiguous()
    ring, want_ring = ss["bufs"][0], ss["bufs"][0].clone()
    pos = torch.zeros(len(caps), dtype=torch.int32, device=cuda)
    want_pos = pos.clone()
    eq = torch.empty(b, c, dtype=torch.int8, device=cuda)
    for t in range(2 * k0 + 1):
        rows = frames[:, t].reshape(b, -1).contiguous()
        before = sf.LAUNCHES["stream_front"]
        sf.stream_front(rows, ring, pos, w0, q.expand_scale, q.expand_shift, eq)
        assert sf.LAUNCHES["stream_front"] == before + 1
        want = sf.stream_front_plain(rows, want_ring, int(want_pos[0]), w0, q.expand_scale,
                                     q.expand_shift)
        torch.cuda.synchronize()
        assert torch.equal(eq, want) and torch.equal(ring, want_ring), t
        assert torch.equal(pos, want_pos), t
        sf.ring_advance(pos, caps)
        sf.ring_advance_plain(want_pos, caps)
        assert torch.equal(pos, want_pos), t


def _graph_lifter(cfg, q, first, device):
    from videopose3d_torch import streaming as st
    lifter = st.StreamingCausalLifter(cfg, engine="int8_fused", quantized=q, device=device)
    lifter.reset(first)
    assert lifter._graph is not None
    return lifter


@pytest.mark.parametrize("c,fw,b,steps", [
    (1024, (3, 3, 3, 3, 3), 1024, 400),  # the stream cell's shape: every ring wraps
    (30, (3, 3, 3), 5, 40),
    (1000, (3, 5, 5), 17, 60),
])
def test_stream_graph_lifter_matches_eager_step(cuda, c, fw, b, steps):
    """The lifter's CUDA graph against stream_step_int8_fused from a copy of its
    state: poses and every ring bitwise at every dispatch, through a reset() halfway
    that reuses the graph; frames from the host and from the card alike."""
    from videopose3d_torch import streaming as st
    cfg, _, _, q, _, first, _ = _stream_setup(c, fw, b, cuda)
    g = torch.Generator().manual_seed(7)
    frames = torch.randn(b, steps, 17, 2, generator=g)
    lifter = _graph_lifter(cfg, q, first, cuda)
    graph = lifter._graph
    w = st.prepare_int8_fused(lifter.quantized)
    eager = _clone(lifter._stream_state)
    for t in range(steps):
        if t == steps // 2:
            lifter.reset(frames[:, t].to(cuda))
            assert lifter._graph is graph
            eager = st.init_stream_state_int8(cfg, q, frames[:, t].to(cuda))
        x = frames[:, t]
        got = lifter.step(x.numpy() if t % 2 else x.to(cuda))
        want, eager = st.stream_step_int8_fused(cfg, w, eager, x.to(cuda))
        assert torch.equal(got, want), t
        assert lifter._stream_state["ptr"] == eager["ptr"]
        assert all(torch.equal(r, e) for r, e in zip(lifter._stream_state["bufs"],
                                                     eager["bufs"])), t


def test_stream_graph_lifter_steps_without_a_fetch(cuda):
    """Two host frames stepped back to back, with no fetch between them: each
    dispatch's poses stay its own (the next replay leaves them unchanged), equal to
    the eager steps', and the profiler's counters show one replay a dispatch; the
    launch counters move by what the capture launched (F, K5, the advance) a
    dispatch."""
    from torch.profiler import ProfilerActivity, profile
    from videopose3d_torch import profiling
    from videopose3d_torch import streaming as st
    cfg, _, _, q, _, first, frames = _stream_setup(64, (3, 3, 3), 9, cuda, seed=5)
    lifter = _graph_lifter(cfg, q, first, cuda)
    w = st.prepare_int8_fused(lifter.quantized)
    eager = _clone(lifter._stream_state)
    host = frames.cpu().numpy()
    profiling.reset_counters()
    before = dict(sf.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [lifter.step(host[:, t]) for t in range(6)]
    counters = profiling.counters()
    assert counters.get("stream.graph_replays") == 6
    assert [(launches, key) for launches, key in lifter._graph.launches] == [
        (sf.LAUNCHES, "stream_front"), (sf.LAUNCHES, "stream_int8"),
        (sf.LAUNCHES, "ring_advance")]
    assert {key: n - before[key] for key, n in sf.LAUNCHES.items() if n != before[key]} == {
        "stream_front": 6, "stream_int8": 6, "ring_advance": 6}
    assert "stream.graph_captures" not in counters  # captured in reset(), unprofiled
    for t, got in enumerate(outs):
        want, eager = st.stream_step_int8_fused(cfg, w, eager, frames[:, t])
        assert torch.equal(got, want), t


def test_stream_graph_leaves_the_other_engines_eager(cuda):
    """bf16_fused, int8_fused at k = 8 and MultiDeviceStreamingLifter's int8_fused
    groups give the free step functions' poses bitwise; only the per-frame
    int8_fused lifters hold a graph."""
    from videopose3d_torch import streaming as st
    cfg, bcfg, model, q, wb, first, frames = _stream_setup(64, (3, 3, 3), 4, cuda, seed=6)
    bf16 = st.StreamingCausalLifter(bcfg, model, engine="bf16_fused", device=cuda)
    multi = st.StreamingCausalLifter(cfg, engine="int8_fused", quantized=q,
                                     frames_per_step=8, device=cuda)
    groups = st.MultiDeviceStreamingLifter(cfg, engine="int8_fused", quantized=q,
                                           devices=[cuda, cuda])
    for lifter in (bf16, multi, groups):
        lifter.reset(first.cpu().numpy())
    assert bf16._graph is None and multi._graph is None
    assert all(g._graph is not None for g in groups.lifters)
    w = st.prepare_int8_fused(q)
    sb = st.init_stream_state(bcfg, model, first)
    s8 = st.init_stream_state_int8_multi(cfg, q, first, 8)
    halves = [st.init_stream_state_int8(cfg, q, first[i:i + 2]) for i in (0, 2)]
    for t in range(0, 32, 8):
        for f in range(t, t + 8):
            want, sb = st.stream_step_bf16_fused(bcfg, wb, sb, frames[:, f])
            assert torch.equal(bf16.step(frames[:, f]), want), f
            got = groups.step(frames[:, f].cpu().numpy())
            for i, part in enumerate((0, 2)):
                want, halves[i] = st.stream_step_int8_fused(cfg, w, halves[i],
                                                            frames[part:part + 2, f])
                assert torch.equal(got[i], want), (f, i)
        want, s8 = st.stream_step_int8_multi_fused(cfg, w, s8, frames[:, t:t + 8])
        assert torch.equal(multi.step(frames[:, t:t + 8]), want), t


# -- the evaluation protocols ----------------------------------------------------


@pytest.mark.parametrize("kind", ["mixed", "tiny", "huge"])
@pytest.mark.parametrize("n", [2, 3, 129, 3500])
@pytest.mark.parametrize("joints", [17, 15])
def test_protocols_kernel_matches_host(cuda, joints, n, kind):
    """The kernel against the host protocols on float64 copies of the same poses
    (relative 1e-9: both float64), reading the first n of n + 7 predicted frames in
    place; a second call bitwise equal (no floating-point atomics)."""
    from protocol_cases import host_protocols, video
    pred, target = video(n, joints, kind, seed=n + joints)
    p, t = torch.from_numpy(pred).to(cuda), torch.from_numpy(target).to(cuda)
    before = pk.LAUNCHES["protocols"]
    got = pk.video_protocols(p, t, n)
    again = pk.video_protocols(p, t, n)
    assert pk.LAUNCHES["protocols"] == before + 2
    assert got.dtype == torch.float64 and got.device == p.device
    np.testing.assert_allclose(got.cpu().numpy(), host_protocols(pred[:n], target),
                               rtol=1e-9, atol=0)
    assert torch.equal(got, again)


def test_protocols_kernel_of_one_frame_and_plain(cuda):
    """n = 1 gives NaN MPJVE as the plain version; at 3,500 frames the plain version
    on the card's inputs agrees to 1e-12."""
    from protocol_cases import video
    for n in (1, 3500):
        pred, target = video(n, 17, seed=7)
        got = pk.video_protocols(torch.from_numpy(pred).to(cuda),
                                 torch.from_numpy(target).to(cuda), n).cpu()
        want = pk.video_protocols_plain(torch.from_numpy(pred), torch.from_numpy(target), n)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0)


def test_protocols_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros(10, 17, 3, device=cuda)
    t = torch.zeros(10, 17, 3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pk.video_protocols(p.double(), t, 10)
    with pytest.raises(ValueError, match="contiguous"):
        pk.video_protocols(torch.zeros(17, 10, 3, device=cuda).transpose(0, 1), t, 10)
    with pytest.raises(ValueError, match="joints"):
        pk.video_protocols(torch.zeros(10, 33, 3, device=cuda),
                           torch.zeros(10, 33, 3, device=cuda), 10)
    with pytest.raises(ValueError, match="target is on"):
        pk.video_protocols(p, t.cpu(), 10)


@pytest.mark.parametrize("engine,widths", [("xla", (3, 3)), ("fused", (3, 3)),
                                           ("int8", (3, 3, 3))])
def test_evaluate_on_card_matches_host_protocols(cuda, engine, widths):
    """``evaluate()`` on the card (one protocol kernel a video, one fetch) equals
    ``evaluate()`` on the CPU over the same predicted poses to 1e-6 relative (the
    host sums in float32), with TTA; ``eval.protocols_on_device`` counts the videos,
    ``vp3d.eval.protocols`` opens once a video and ``vp3d.eval.fetch`` once, the
    card copies to the host once a call; two card devices round-robin give the
    same numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch_parallel_workers as W
    from videopose3d_torch import evaluate as ev
    from videopose3d_torch import profiling
    from videopose3d_torch.data import generators as tgen
    from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                    receptive_field)
    lengths = (21, 300, 129, 1000)
    p2, p3, _ = W.videos(seed=9, lengths=lengths)
    perm = W.flip_perm()
    torch.manual_seed(4)
    cfg = TemporalModelConfig(W.J, 2, W.J, widths, channels=W.CHANNELS)
    net = TemporalModel(cfg).eval().to(cuda)
    pad = (receptive_field(cfg) - 1) // 2
    batcher = tgen.UnchunkedBatcher(None, p3, p2, pad=pad, causal_shift=0, augment=True,
                                    kps_flip_perm=perm, joints_flip_perm=perm, bucket=16)
    card = ev.Evaluator(net.config, joints_flip_perm=perm, engine=engine, device=cuda)
    poses = []
    predict = card.predict_async

    def recorded(model, batch_2d, augment, device=None):
        poses.append(predict(model, batch_2d, augment, device))
        return poses[-1]

    ev.evaluate(card, net, batcher, verbose=False)  # warm-up: copies, plans, pinned pool
    card.predict_async = recorded
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = ev.evaluate(card, net, batcher, verbose=False)
    counters = profiling.counters()
    events = prof.events()
    names = [e.name for e in events if e.device_type == DeviceType.CPU]
    assert counters["eval.protocols_on_device"] == len(lengths)
    assert counters["eval.frames"] == sum(lengths)
    assert names.count("vp3d.eval.protocols") == len(lengths)
    assert names.count("vp3d.eval.fetch") == 1
    assert "vp3d.eval.p_mpjpe" not in names
    fetches = [e.name for e in events if "DtoH" in e.name]
    assert len(fetches) == 1, fetches
    host = ev.Evaluator(net.config, joints_flip_perm=perm, engine=engine,
                        device=torch.device("cpu"))
    fetched = iter([p.cpu() for p in poses])
    host.predict_async = lambda model, batch_2d, augment, device=None: next(fetched)
    want = ev.evaluate(host, net, batcher, verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    card.predict_async = predict
    assert ev.evaluate(card, net, batcher, verbose=False, devices=[cuda, cuda]) == got
