"""The fused streaming steps (K5 per frame, K6 k frames per step; int8 and bf16)
of videopose3d_torch against videopose3d_tpu's fused kernels, which run in
Pallas interpret mode on the CPU, and against the port's own per-layer engines.
On the CPU the port's wrappers take their plain versions.

Each run steps past max(cap) so that every ring wraps; k = 4 and 8 give taps
whose lag is shorter than the step (read from the step's own frames).
Tolerances as in tests/test_torch_streaming.py: the port's fused and per-layer
engines are bitwise equal; against JAX, int8 streams within one step on at
most 1e-3 of their elements and poses within 1e-3 (XLA's fused multiply-adds
on the CPU), bfloat16 within 1.6e-2 of max(1, max |want|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu import streaming as js
from videopose3d_torch import streaming as ts
from videopose3d_torch.ops.kernels import streaming_fused as sf

from torch_port_helpers import (INT8_POSE_TOL, STREAM_TOL, assert_close,
                                assert_states_agree, quantized_pair, stream_models)


def _clone(ss):
    return {"bufs": [b.clone() for b in ss["bufs"]], "ptr": list(ss["ptr"])}


def _frames(rng, b, k):
    shape = (b, 17, 2) if k == 1 else (b, k, 17, 2)
    return rng.standard_normal(shape).astype(np.float32)


def _n_steps(cfg, k):
    return (max(js._buffer_capacities(cfg)) + 3 * k) // k + 1


def _run(cfg, k, j_fused, p_fused, p_layer, jss, pss, b, tol, seed):
    """Steps the JAX fused engine, the port's fused engine and the port's
    per-layer engine from one state: the port's two bitwise equal at every step,
    the port's fused within ``tol`` of JAX's, every ring at the end."""
    rng = np.random.default_rng(seed)
    layer = _clone(pss)
    for t in range(_n_steps(cfg, k)):
        frames = _frames(rng, b, k)
        want, jss = j_fused(jss, jnp.asarray(frames))
        got, pss = p_fused(pss, torch.from_numpy(frames))
        ref, layer = p_layer(layer, torch.from_numpy(frames))
        assert torch.equal(got, ref), f"fused vs per-layer at step {t}"
        assert all(torch.equal(a, r) for a, r in zip(pss["bufs"], layer["bufs"]))
        assert pss["ptr"] == layer["ptr"]
        assert_close(got, want, tol, f"step {t}")
    assert_states_agree(pss, jss)


@pytest.mark.parametrize("fw,ch,b", [((3, 3, 3), 32, 3), ((3, 5, 5), 16, 2),
                                     ((3, 3, 3), 30, 3)])
def test_fused_int8_step_matches_jax(fw, ch, b):
    """K5 int8: stream_step_int8_fused against the JAX fused kernel, also at a
    width that is not a multiple of 16 (the kernel takes any C)."""
    cfg, params, state, tcfg, _ = stream_models(fw, ch)
    q, tq = quantized_pair(cfg, params, state, seed=1)
    tprep = ts.prepare_int8_fused(tq)
    first = _frames(np.random.default_rng(0), b, 1)
    jss = js.init_stream_state_int8(cfg, q, jnp.asarray(first))
    pss = ts.init_stream_state_int8(tcfg, tq, torch.from_numpy(first))
    _run(cfg, 1, lambda s, f: js.stream_step_int8_fused(cfg, q, s, f),
         lambda s, f: ts.stream_step_int8_fused(tcfg, tprep, s, f),
          lambda s, f: ts.stream_step_int8(tcfg, tq, s, f),
         jss, pss, b, INT8_POSE_TOL, seed=1)


@pytest.mark.parametrize("fw,ch,b", [((3, 3, 3), 32, 3), ((3, 5, 5), 16, 2)])
def test_fused_bf16_step_matches_jax(fw, ch, b):
    """K5 bf16: stream_step_bf16_fused against the JAX fused kernel."""
    cfg, params, state, tcfg, model = stream_models(fw, ch, "bfloat16", seed=2)
    prepared = js.prepare_bf16_fused(cfg, params, state)
    tprep = ts.prepare_bf16_fused(tcfg, model)
    first = _frames(np.random.default_rng(0), b, 1)
    jss = js.init_stream_state(cfg, params, state, jnp.asarray(first))
    pss = ts.init_stream_state(tcfg, model, torch.from_numpy(first))
    _run(cfg, 1, lambda s, f: js.stream_step_bf16_fused(cfg, prepared, s, f),
         lambda s, f: ts.stream_step_bf16_fused(tcfg, tprep, s, f),
          lambda s, f: ts.stream_step(tcfg, tprep, s, f),
         jss, pss, b, STREAM_TOL["bfloat16"], seed=2)


@pytest.mark.parametrize("k,b", [(4, 3), (8, 2)])
def test_fused_int8_multi_step_matches_jax(k, b):
    """K6 int8 against the JAX k-frame fused kernel; block 1's taps (lags 6, 3)
    reach into the step's own frames."""
    cfg, params, state, tcfg, _ = stream_models((3, 3, 3), 32, seed=3)
    q, tq = quantized_pair(cfg, params, state, seed=3)
    tprep = ts.prepare_int8_fused(tq)
    first = _frames(np.random.default_rng(0), b, 1)
    jss = js.init_stream_state_int8_multi(cfg, q, jnp.asarray(first), k)
    pss = ts.init_stream_state_int8_multi(tcfg, tq, torch.from_numpy(first), k)
    _run(cfg, k, lambda s, f: js.stream_step_int8_multi_fused(cfg, q, s, f),
         lambda s, f: ts.stream_step_int8_multi_fused(tcfg, tprep, s, f),
          lambda s, f: ts.stream_step_int8_multi(tcfg, tq, s, f),
         jss, pss, b, INT8_POSE_TOL, seed=3)


@pytest.mark.parametrize("k,b", [(4, 3), (8, 2)])
def test_fused_bf16_multi_step_matches_jax(k, b):
    """K6 bf16 against the JAX k-frame fused kernel."""
    cfg, params, state, tcfg, model = stream_models((3, 3, 3), 32, "bfloat16", seed=4)
    prepared = js.prepare_bf16_fused(cfg, params, state)
    tprep = ts.prepare_bf16_fused(tcfg, model)
    first = _frames(np.random.default_rng(0), b, 1)
    jss = js.init_stream_state_multi(cfg, params, state, jnp.asarray(first), k)
    pss = ts.init_stream_state_multi(tcfg, model, torch.from_numpy(first), k)
    _run(cfg, k, lambda s, f: js.stream_step_bf16_multi_fused(cfg, prepared, s, f),
         lambda s, f: ts.stream_step_bf16_multi_fused(tcfg, tprep, s, f),
          lambda s, f: ts.stream_step_multi(tcfg, tprep, s, f),
         jss, pss, b, STREAM_TOL["bfloat16"], seed=4)


def test_multi_step_equals_per_frame_step():
    """K6 at k = 8 against K5 over the same 64 frames: poses equal but for the
    shrink's float32 sums over other row counts, and every ring's history (the
    last cap frames of the per-frame ring) equal once the doubled, k-aligned
    ring is read at its own positions."""
    cfg, params, state, tcfg, _ = stream_models((3, 3, 3), 32, seed=5)
    _, tq = quantized_pair(cfg, params, state, seed=5)
    tprep = ts.prepare_int8_fused(tq)
    rng = np.random.default_rng(5)
    b, k = 3, 8
    first = torch.from_numpy(_frames(rng, b, 1))
    one = ts.init_stream_state_int8(tcfg, tq, first)
    multi = ts.init_stream_state_int8_multi(tcfg, tq, first, k)
    frames = torch.from_numpy(rng.standard_normal((b, 64, 17, 2)).astype(np.float32))
    per_frame = []
    for t in range(64):
        p, one = ts.stream_step_int8_fused(tcfg, tprep, one, frames[:, t])
        per_frame.append(p)
    stepped = []
    for t in range(0, 64, k):
        p, multi = ts.stream_step_int8_multi_fused(tcfg, tprep, multi, frames[:, t:t + k])
        stepped.append(p)
    assert_close(torch.cat(stepped, 1), torch.stack(per_frame, 1), 1e-5)
    caps = ts._buffer_capacities(tcfg)
    for ring1, ring_k, cap, p1, pk in zip(one["bufs"], multi["bufs"], caps, one["ptr"],
                                          multi["ptr"]):
        cap_k = ring_k.shape[0] // 2
        for lag in range(1, cap + 1):
            assert torch.equal(ring1[(p1 - lag) % cap], ring_k[(pk - lag) % cap_k])


def test_plain_steps_update_the_rings_in_place():
    """The plain twins write the caller's rings (the kernels do too) and return
    them; slots come from the host as ints."""
    cfg, params, state, tcfg, _ = stream_models((3, 3, 3), 16, seed=6)
    _, tq = quantized_pair(cfg, params, state, seed=6)
    ss = ts.init_stream_state_int8(tcfg, tq, torch.zeros(2, 17, 2))
    rings = ss["bufs"][1:]
    ids = [r.data_ptr() for r in rings]
    eq = torch.full((2, 16), 5, dtype=torch.int8)
    idx, _ = ts._slots(tcfg, [0, 4, 10], ts._buffer_capacities(tcfg), multi=False)
    assert idx == [4, 5, 1, 10, 11, 1]   # [write, lag 2d, lag d] per block
    poses, out = sf.fused_blocks_step(ts.prepare_int8_fused(tq), rings, eq, idx,
                                      widths=(3, 3))
    assert poses.shape == (2, 51) and [r.data_ptr() for r in out] == ids
    assert torch.equal(rings[0][4], eq)
    assert sf.LAUNCHES == {k: 0 for k in sf.LAUNCHES}   # the CPU launches no kernel


def _torch_int8_model(fw, ch, seed):
    """A causal model of the port alone (random BatchNorm statistics) and its w8a8
    copy from the port's quantizer."""
    from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                    receptive_field)
    from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
    torch.manual_seed(seed)
    cfg = TemporalModelConfig(num_joints_in=17, in_features=2, num_joints_out=17,
                              filter_widths=fw, causal=True, channels=ch)
    model = TemporalModel(cfg).eval()
    for bn in [model.expand_bn, *model.layers_bn]:
        bn.running_var.uniform_(0.5, 2.0)
        bn.bias.data.uniform_(-0.2, 0.2)
    calib = torch.rand(1, receptive_field(cfg) + 64, 17, 2) * 2 - 1
    return cfg, quantize_temporal_model(cfg, model, calib)


# The 243-frame model's rings (3, 7, 19, 55, 163 rows): 330 dispatches wrap the
# 163-row ring twice; and a narrow model at a width off the 16-byte word.
DEVICE_POSITION_CASES = [((3, 3, 3, 3, 3), 16, 2, 330), ((3, 5, 5), 30, 3, 120)]


@pytest.mark.parametrize("fw,ch,b,steps", DEVICE_POSITION_CASES)
def test_front_and_device_positions_equal_the_eager_ring_and_slots(fw, ch, b, steps):
    """The streaming front's plain version against the eager raw-ring push and
    expand (``_per_frame`` + ``_expand_step_i8``): eq and the raw ring bitwise at
    every dispatch; the slots and advance of the positions on the device equal
    ``_slots`` and ``_advance_ptrs`` at every dispatch."""
    cfg, q = _torch_int8_model(fw, ch, seed=7)
    rng = np.random.default_rng(7)
    ss = ts.init_stream_state_int8(cfg, q, torch.from_numpy(_frames(rng, b, 1)))
    raw = ss["bufs"][0].clone()
    caps = ts._buffer_capacities(cfg)
    pos = torch.tensor(ss["ptr"], dtype=torch.int32)
    k0, c_in, c = q.expand_w.shape
    w0 = q.expand_w.reshape(k0 * c_in, c)
    _, lags = ts._slots(cfg, ss["ptr"], caps, multi=False)
    for t in range(steps):
        frame = torch.from_numpy(_frames(rng, b, 1))
        bufs, ptr, _, taps = ts._per_frame(cfg, ss, frame, torch.bfloat16)
        want = ts._expand_step_i8(q, taps)
        got = sf.stream_front_plain(frame.reshape(b, -1), raw, int(pos[0]), w0,
                                    q.expand_scale, q.expand_shift)
        assert torch.equal(got, want) and torch.equal(raw, bufs[0]), t
        idx, _ = ts._slots(cfg, ptr, caps, multi=False)
        assert sf.device_slots_plain(pos, caps[1:], lags) == idx, t
        ss = {"bufs": bufs, "ptr": ts._advance_ptrs(ptr, caps)}
        assert sf.ring_advance_plain(pos, caps).tolist() == ss["ptr"], t


@pytest.mark.parametrize("fw,ch,b,steps", DEVICE_POSITION_CASES)
def test_device_position_step_equals_the_eager_step(fw, ch, b, steps):
    """What the lifter's CUDA graph captures (the front, K5 on the positions on the
    device, the advance), run by its plain versions, against stream_step_int8_fused
    from one state: poses, every ring and the positions bitwise at every dispatch."""
    cfg, q = _torch_int8_model(fw, ch, seed=8)
    w = ts.prepare_int8_fused(q)
    rng = np.random.default_rng(8)
    eager = ts.init_stream_state_int8(cfg, q, torch.from_numpy(_frames(rng, b, 1)))
    bufs = [r.clone() for r in eager["bufs"]]
    pos = torch.tensor(eager["ptr"], dtype=torch.int32)
    k0, c_in, c = q.expand_w.shape
    _, lags = ts._slots(cfg, eager["ptr"], ts._buffer_capacities(cfg), multi=False)
    eq = torch.empty(b, c, dtype=torch.int8)
    for t in range(steps):
        frame = torch.from_numpy(_frames(rng, b, 1))
        want, eager = ts.stream_step_int8_fused(cfg, w, eager, frame)
        got = ts._step_on_device_positions(cfg, w, q.expand_w.reshape(k0 * c_in, c), lags,
                                           bufs, pos, frame.reshape(b, -1), eq)
        assert torch.equal(got.reshape(want.shape), want), t
        assert all(torch.equal(r, e) for r, e in zip(bufs, eager["bufs"])), t
        assert pos.tolist() == eager["ptr"], t


def test_cpu_lifter_stays_eager():
    """On the CPU the int8_fused lifter steps the free function's plain path: no
    graph, no graph counters under a profiler, and its poses."""
    from torch.profiler import ProfilerActivity, profile
    from videopose3d_torch import profiling
    cfg, q = _torch_int8_model((3, 3, 3), 16, seed=9)
    rng = np.random.default_rng(9)
    first = _frames(rng, 2, 1)
    lifter = ts.StreamingCausalLifter(cfg, engine="int8_fused", quantized=q, device="cpu")
    lifter.reset(first)
    ss = ts.init_stream_state_int8(cfg, q, torch.from_numpy(first))
    w = ts.prepare_int8_fused(q)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            frame = _frames(rng, 2, 1)
            want, ss = ts.stream_step_int8_fused(cfg, w, ss, torch.from_numpy(frame))
            assert torch.equal(lifter.step(frame), want)
    assert lifter._graph is None
    assert not any(k.startswith("stream.graph") for k in profiling.counters())
