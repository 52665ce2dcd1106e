"""videopose3d_torch's int8 serving path against videopose3d_tpu's
(``ops/pallas/temporal_block_int8.py``, Pallas in interpret mode) on seeded
numpy inputs and identical weights.

Tolerances and why:
* Calibration ranges: float32 convolutions summed in another order; a channel's
  absmax moves by float32 rounding of its layer's sums, ~1e-6 of the layer's
  largest range, so |diff| <= 1e-5 * |want| + 1e-6 * max(layer).
* Quantizer from JAX's ranges: int8 weights equal; f32 epilogue vectors within
  1e-6 relative, plus 1e-6 of the vector's max where the folded BatchNorm shift
  ``bias - mean * scale`` cancels (torch's and XLA's rsqrt may differ by an ulp).
* Stages and the whole forward, on one quantized model (``q_from_jax``): not
  bitwise, because XLA on the CPU contracts the epilogues' ``a * s + b`` into one
  fused multiply-add where torch rounds the product and the sum separately.  That
  moves a value by about an ulp and flips a rounding of the int8 stream only at a
  tie: the int8 streams agree except on at most 1e-3 of their elements, by at
  most one step, and the poses within 1e-3 * max(1, max |JAX|).
* Accuracy of int8 against the float32 model, the JAX package's own bound
  (``tests/test_int8_serving.py``): mean per-joint error < 0.06 * RMS(f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu.models.temporal import receptive_field
from videopose3d_tpu.ops.pallas import temporal_block_int8 as jq
from videopose3d_torch.evaluate import Evaluator
from videopose3d_torch.models.convert import q_from_jax
from videopose3d_torch.models.temporal import forward_dilated, forward_dilated_int8
from videopose3d_torch.ops.kernels import temporal_block as ttb
from videopose3d_torch.ops.kernels import temporal_block_int8 as tq

from torch_port_helpers import jax_model

STREAM_FRAC = 1e-3
POSE_TOL = 1e-3


def _setup(fw=(3, 3, 3), channels=64, causal=False, seed=0):
    kwargs = dict(num_joints_in=17, in_features=2, num_joints_out=17,
                  filter_widths=fw, causal=causal, channels=channels)
    cfg, params, state, tcfg, model = jax_model(kwargs, seed=seed)
    rf = receptive_field(cfg)
    rng = np.random.default_rng(seed)
    calib = rng.standard_normal((2, rf + 64, 17, 2)).astype(np.float32)
    x = rng.standard_normal((2, rf + 40, 17, 2)).astype(np.float32)
    return cfg, params, state, tcfg, model, calib, x


def _jax_q(cfg, params, state, calib):
    q = jq.quantize_temporal_model(cfg, params, state, jnp.asarray(calib))
    return q, q_from_jax(jax.tree_util.tree_map(np.asarray, q))


def _assert_streams_agree(got, want):
    """int8 streams: equal but on at most STREAM_FRAC of elements, by one step."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= STREAM_FRAC, (
        diff.max(), (diff > 0).mean())


def _assert_poses_agree(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= POSE_TOL * max(1.0, np.abs(want).max()), err


CONFIGS = [((3, 3, 3), 64, False), ((3, 3, 3), 64, True), ((3, 3, 3, 3), 32, False),
           ((3, 3, 3, 3), 32, True), ((5, 5, 5), 64, False)]


@pytest.mark.parametrize("fw,channels,causal", CONFIGS)
def test_calibration_ranges_match_jax(fw, channels, causal):
    cfg, params, state, _, model, calib, _ = _setup(fw, channels, causal, seed=1)
    want = jq._calibration_ranges(cfg, params, state, jnp.asarray(calib))
    got = tq.calibration_ranges(model, torch.from_numpy(calib))
    assert len(got["h"]) == len(got["stream"]) == len(fw) - 1
    for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * w.max())


@pytest.mark.parametrize("fw,channels,causal", CONFIGS)
def test_quantizer_matches_jax_on_jax_ranges(fw, channels, causal):
    cfg, params, state, tcfg, model, calib, _ = _setup(fw, channels, causal, seed=2)
    caps = jq._calibration_ranges(cfg, params, state, jnp.asarray(calib))
    want = jq.quantize_temporal_model(cfg, params, state, jnp.asarray(calib))
    got = tq.quantize_from_ranges(
        tcfg, model, jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                                            caps))

    def close(g, w):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())

    assert len(got.blocks) == len(want["blocks"])
    for g, w in zip(got.blocks, want["blocks"]):
        for name in ("wq_a", "wq_b"):
            assert getattr(g, name).dtype == torch.int8
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(w[name]))
        for name in ("A1", "B1", "A2", "B2", "R"):
            close(getattr(g, name), w[name])
    for name in ("expand_scale", "expand_shift", "shrink_b"):
        close(getattr(got, name), want[name])
    for name in ("expand_w", "shrink_w"):
        assert getattr(got, name).dtype == torch.bfloat16
        np.testing.assert_array_equal(getattr(got, name).float().numpy(),
                                      np.asarray(want[name]).astype(np.float32))


@pytest.mark.parametrize("fw,kwargs,frames,match", [
    ((3, 3, 3), dict(dense=True), 64, "dense"),
    ((3, 3), {}, 64, "at least 2 residual blocks"),
    ((3, 3, 3), {}, 26, "receptive field is 27"),
])
def test_quantizer_rejects_what_jax_rejects(fw, kwargs, frames, match):
    cfg_kwargs = dict(num_joints_in=17, in_features=2, num_joints_out=17,
                      filter_widths=fw, channels=16, **kwargs)
    cfg, params, state, tcfg, model = jax_model(cfg_kwargs)
    calib = np.zeros((1, frames, 17, 2), np.float32)
    with pytest.raises(ValueError, match=match):
        tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
    with pytest.raises(ValueError):
        jq.quantize_temporal_model(cfg, params, state, jnp.asarray(calib))


@pytest.mark.parametrize("tap_mode", ["slice", "accshift"])
@pytest.mark.parametrize("fw,channels,causal,block", [
    ((3, 3, 3), 64, False, 1), ((3, 3, 3), 64, True, 1), ((3, 3, 3, 3), 32, True, 2),
    ((5, 5, 5), 64, False, 1)])
def test_mid_block_plain_matches_jax(tap_mode, fw, channels, causal, block):
    """A mid stage on one int8 stream, against ``_mid_block_i8`` in the same tap
    mode, at the block's dilation (9, 27 or 25: every tap but the first sits at
    an offset that is not a multiple of 32)."""
    cfg, params, state, _, _, calib, _ = _setup(fw, channels, causal, seed=3)
    qj, q = _jax_q(cfg, params, state, calib)
    d, shift = cfg.dilations[block + 1], cfg.causal_shifts_dilated[block + 1]
    span = (fw[block + 1] - 1) * d
    rng = np.random.default_rng(4)
    t = span + 70
    xs = rng.integers(0, 128, (2, t, channels)).astype(np.int8)
    out, valid = jq._mid_block_i8(jnp.asarray(xs), t, qj["blocks"][block], dilation=d,
                                  causal_shift=shift, t_tile=32, interpret=True,
                                  tap_mode=tap_mode)
    want = np.asarray(out)[:, :valid]
    got = tq.int8_dilated_block_plain(torch.from_numpy(xs), q.blocks[block], dilation=d,
                                      causal_shift=shift, tap_mode=tap_mode)
    assert valid == t - span
    _assert_streams_agree(got.numpy(), want)
    # The wrapper takes the plain version for a CPU tensor and launches nothing.
    before = dict(tq.LAUNCHES)
    same = tq.int8_dilated_block(torch.from_numpy(xs), q.blocks[block], dilation=d,
                                 causal_shift=shift, tap_mode=tap_mode)
    assert torch.equal(same, got) and tq.LAUNCHES == before


@pytest.mark.parametrize("fw,channels,causal", CONFIGS)
def test_forward_int8_matches_jax(fw, channels, causal):
    """The whole int8 forward (expand + block 0, mid blocks, last block + shrink)
    on one quantized model, both tap modes against JAX's."""
    cfg, params, state, tcfg, _, calib, x = _setup(fw, channels, causal, seed=5)
    qj, q = _jax_q(cfg, params, state, calib)
    for min_d in (10 ** 9, 0):
        want = np.asarray(jq.forward_dilated_int8(cfg, qj, jnp.asarray(x), interpret=True,
                                                  t_tile=32, accshift_min_d=min_d))
        got = forward_dilated_int8(tcfg, q, torch.from_numpy(x), accshift_min_d=min_d)
        assert got.dtype == torch.float32
        _assert_poses_agree(got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_int8_at_30_channels_matches_jax(causal):
    """30 channels are not a multiple of the stage kernels' 16: the int8 forward
    runs the model zero-padded to 32 channels (on every device) and agrees with
    JAX's int8 path on the unpadded model."""
    cfg, params, state, tcfg, _, calib, x = _setup((3, 3, 3), 30, causal, seed=8)
    qj, q = _jax_q(cfg, params, state, calib)
    want = np.asarray(jq.forward_dilated_int8(cfg, qj, jnp.asarray(x), interpret=True,
                                              t_tile=32))
    got = forward_dilated_int8(tcfg, q, torch.from_numpy(x))
    _assert_poses_agree(got.numpy(), want)
    assert q.padded.blocks[0].wq_a.shape == (3, 32, 32)
    assert tq.channel_padded(q) is q.padded


def test_padded_forward_is_bitwise_the_unpadded_one():
    """Zero channels appended to a 32-channel model (to 48) leave every int32 sum,
    row maximum and pose as they were: the forward gives the same bits, in both
    tap modes."""
    cfg, params, state, tcfg, model, calib, x = _setup((3, 3, 3, 3), 32, False, seed=9)
    q = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
    padded = tq.pad_channels(q, 48)
    assert padded.blocks[1].pb.shape == (16, 48) and padded.shrink_w.shape == (48, 51)
    xt = torch.from_numpy(x)
    for min_d in (10 ** 9, 0):
        assert torch.equal(forward_dilated_int8(tcfg, padded, xt, accshift_min_d=min_d),
                           forward_dilated_int8(tcfg, q, xt, accshift_min_d=min_d))


@pytest.mark.parametrize("fw,channels,causal", CONFIGS)
def test_accshift_is_bitwise_slice(fw, channels, causal):
    """Each plain stage and the whole forward give the same bits in both tap
    modes (integer sums commute; the residual convert is elementwise)."""
    cfg, params, state, tcfg, model, calib, x = _setup(fw, channels, causal, seed=6)
    q = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
    xt = torch.from_numpy(x)
    base = forward_dilated_int8(tcfg, q, xt)
    assert torch.equal(forward_dilated_int8(tcfg, q, xt, accshift_min_d=0), base)
    assert torch.equal(forward_dilated_int8(tcfg, q, xt, accshift_min_d=27), base)
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.integers(0, 128, (2, 150, channels)).astype(np.int8))
    w0 = q.expand_w.reshape(-1, channels)
    x_taps = torch.from_numpy(rng.uniform(-1, 1, (2, 150, w0.shape[0])).astype(np.float32))
    for d, shift in ((9, 0), (27, 27), (5, 5)):
        args = dict(dilation=d, causal_shift=shift)
        stages = [lambda m: tq.int8_dilated_block_plain(xs, q.blocks[0], tap_mode=m,
                                                        **args),
                  lambda m: tq.int8_shrink_block_plain(xs, q.blocks[-1], q.shrink_w,
                                                       q.shrink_b, tap_mode=m, **args),
                  lambda m: tq.int8_expand_block_plain(
                      x_taps, w0, q.expand_scale, q.expand_shift, q.blocks[0],
                      tap_mode=m, **args)]
        for stage in stages:
            assert torch.equal(stage("accshift"), stage("slice"))


def test_output_geometry_and_stage_shapes():
    cfg, params, state, tcfg, model, calib, _ = _setup()
    q = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
    rf = receptive_field(cfg)
    out = forward_dilated_int8(tcfg, q, torch.zeros(3, rf + 7, 17, 2))
    assert out.shape == (3, 8, 17, 3) and out.dtype == torch.float32
    out = forward_dilated_int8(tcfg, q, torch.zeros(1, rf, 34))  # flat input, one frame
    assert out.shape == (1, 1, 17, 3)
    with pytest.raises(ValueError, match="receptive field"):
        forward_dilated_int8(tcfg, q, torch.zeros(1, rf - 1, 17, 2))
    xs = torch.zeros(2, 40, 64, dtype=torch.int8)
    assert tq.int8_dilated_block(xs, q.blocks[0], dilation=9).shape == (2, 22, 64)
    assert tq.int8_shrink_block(xs, q.blocks[1], q.shrink_w, q.shrink_b,
                                dilation=3).shape == (2, 34, 51)


@pytest.mark.parametrize("channels", [32, 48])
def test_int8_block_packs_are_pack_int8_steps(channels):
    """An Int8Block packs each tap of wq_a and wq_b once with pack_int8_step, the
    layout of the stage kernels and of the fused streaming step: int32 (g, n) holds
    w[4g .. 4g+3, n] in order, zero past K (padded to 32); the fused step reuses
    the same tensors."""
    from videopose3d_torch.ops.kernels.streaming_fused import Int8StepWeights
    _, _, _, tcfg, model, calib, _ = _setup(channels=channels)
    q = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
    kp = -(-channels // 32) * 32
    for blk in q.blocks:
        assert torch.equal(blk.pa, torch.stack([tq.pack_int8_step(w) for w in blk.wq_a]))
        assert torch.equal(blk.pb, tq.pack_int8_step(blk.wq_b))
        for w, packed in [*zip(blk.wq_a, blk.pa), (blk.wq_b, blk.pb)]:
            k, n = w.shape
            assert packed.dtype == torch.int32 and packed.shape == (kp // 4, n)
            unpacked = packed.contiguous().view(torch.int8).reshape(kp // 4, n, 4)
            full = unpacked.permute(0, 2, 1).reshape(kp, n)
            assert torch.equal(full[:k], w) and not full[k:].any()
    step = Int8StepWeights.of(q)
    assert all(wa is blk.pa and wb is blk.pb for (wa, wb), blk in zip(step.packs, q.blocks))


def test_shrink_operands_are_padded_once_per_model():
    """The shrink kernel's (C, J) bf16 weights and (J,) bias, zero-padded to whole
    16-byte words of output columns (51 -> 56), are made once and kept on the
    model; a model built after another is freed gets its own, however the
    allocator and the interpreter reuse the old tensors' memory and ids."""
    _, _, _, tcfg, model, calib, _ = _setup(channels=32)
    for seed in (11, 12, 13):
        q = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
        rng = np.random.default_rng(seed)
        q.shrink_w = torch.from_numpy(
            rng.standard_normal((32, 51)).astype(np.float32)).to(torch.bfloat16)
        q.shrink_b = torch.from_numpy(rng.standard_normal(51).astype(np.float32))
        wp, bp = tq.shrink_operands(q)
        assert wp.shape == (32, 56) and bp.shape == (56,)
        assert torch.equal(wp[:, :51], q.shrink_w) and torch.equal(bp[:51], q.shrink_b)
        assert not wp[:, 51:].any() and not bp[51:].any()
        assert tq.shrink_operands(q)[0] is wp
        del q, wp, bp


@pytest.mark.parametrize("m,slices", [(4468, 2), (4432, 2), (4324, 2), (4000, 1)])
def test_int8_plan_at_the_evaluation_shapes(m, slices):
    """The int8 stages' GEMMs at B = 2, T = 2,242, C = 1,024 on 132 SMs (the expand,
    the two mid blocks and the shrink: 280 / 280 / 272 / 256 tiles on 264 resident
    blocks): the tap GEMM (K = 3,072), the 1x1 and the accshift mode's tap GEMM
    of its aligned taps (K = 1,024) split as kernel_ab.py's int8 sweep on an H100
    chose (PERF.md): in 2 where the tiles spill past one wave, else not; each
    slice a whole number of 64-value K tiles.  The bf16 projection keeps K3's."""
    for k in (3072, 1024):
        plan = tq.int8_plan(m, k, 1024, 132)
        assert len(plan) == slices
        assert plan[0][0] == 0 and plan[-1][1] == k
        assert all(a % 64 == 0 for a, _ in plan)
        assert tq.stage_plan(m, k, 1024, 132, torch.int8) == plan
    assert tq.stage_plan(m, 1024, 56, 132, torch.bfloat16) == ttb.k3_plan(
        m, 1024, 56, 132, torch.bfloat16)


@pytest.mark.parametrize("fw,channels,causal", [((3, 3, 3), 64, False),
                                                ((3, 3, 3, 3), 32, True),
                                                ((5, 5, 5), 64, False)])
def test_int8_accuracy_vs_f32(fw, channels, causal):
    """Random weights and inputs, the worst case for post-training quantization,
    against the port's own float32 model."""
    _, _, _, tcfg, model, calib, x = _setup(fw, channels, causal, seed=8)
    q = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
    want = forward_dilated(model, torch.from_numpy(x)).numpy()
    got = forward_dilated_int8(tcfg, q, torch.from_numpy(x)).numpy()
    per_joint = np.linalg.norm(got - want, axis=-1).mean()
    assert per_joint < 0.06 * np.sqrt((want ** 2).mean())


def _evaluators(tcfg):
    cpu = torch.device("cpu")
    return (Evaluator(tcfg, joints_flip_perm=np.arange(17), device=cpu),
            Evaluator(tcfg, joints_flip_perm=np.arange(17), engine="int8", device=cpu))


def test_evaluator_int8_engine():
    _, _, _, tcfg, model, _, x = _setup()
    exact, ev = _evaluators(tcfg)
    want = exact.predict_async(model, x[:1], augment=False).numpy()
    got = ev.predict_async(model, x[:1], augment=False).numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want, axis=-1).mean() < 0.06 * np.sqrt((want ** 2).mean())
    # Quantized on that batch, and cached while the weights stay.
    q = ev._q
    direct = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(x[:1]))
    assert torch.equal(q.blocks[0].wq_a, direct.blocks[0].wq_a)
    ev.predict_async(model, x[1:], augment=False)
    assert ev._q is q
    ev.reset_quantization()
    assert ev._q is None


def test_evaluator_set_calibration_equals_direct_quantization():
    _, _, _, tcfg, model, calib, x = _setup()
    _, ev = _evaluators(tcfg)
    clips = [calib[:1, :50], calib[1:, 20:]]   # ragged: flattened to one time axis
    ev.set_calibration(clips)
    got = ev.predict_async(model, x[:1], augment=False)
    flat = torch.from_numpy(np.concatenate([c.reshape(1, -1, 17, 2) for c in clips], 1))
    direct = tq.quantize_temporal_model(tcfg, model, flat)
    for g, w in zip(ev._q.blocks, direct.blocks):
        for name in ("wq_a", "wq_b", "A1", "B1", "A2", "B2", "R"):
            assert torch.equal(getattr(g, name), getattr(w, name))
    assert torch.equal(got, forward_dilated_int8(tcfg, direct, torch.from_numpy(x[:1])))


def test_evaluator_requantizes_after_in_place_load_state_dict():
    """``load_state_dict`` (what the runner's ``load_model`` and an optimizer
    step do) writes into the same tensors: the cache must see the change."""
    _, _, _, tcfg, model, _, x = _setup(seed=9)
    _, _, _, _, other, _, _ = _setup(seed=10)
    _, ev = _evaluators(tcfg)
    ids = [id(p) for p in model.parameters()]
    first = ev.predict_async(model, x[:1], augment=False)
    q = ev._q
    model.load_state_dict(other.state_dict())
    assert [id(p) for p in model.parameters()] == ids      # the same tensors
    got = ev.predict_async(model, x[:1], augment=False)
    assert ev._q is not q
    want = forward_dilated_int8(
        tcfg, tq.quantize_temporal_model(tcfg, other, torch.from_numpy(x[:1])),
        torch.from_numpy(x[:1]))
    assert torch.equal(got, want) and not torch.equal(got, first)


def test_wrappers_raise_for_a_tensor_that_is_neither_cpu_nor_cuda():
    _, _, _, tcfg, model, calib, _ = _setup(channels=32)
    q = tq.quantize_temporal_model(tcfg, model, torch.from_numpy(calib))
    before = dict(tq.LAUNCHES)
    xs = torch.zeros(2, 40, 32, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.int8_dilated_block(xs, q.blocks[0], dilation=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.int8_shrink_block(xs, q.blocks[1], q.shrink_w, q.shrink_b, dilation=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.int8_expand_block(torch.zeros(2, 40, 102, device="meta"),
                             q.expand_w.reshape(-1, 32), q.expand_scale, q.expand_shift,
                             q.blocks[0], dilation=3)
    with pytest.raises(ValueError, match="tap_mode"):
        tq.int8_dilated_block_plain(torch.zeros(2, 40, 32, dtype=torch.int8), q.blocks[0],
                                    dilation=3, tap_mode="x")
    assert tq.LAUNCHES == before
