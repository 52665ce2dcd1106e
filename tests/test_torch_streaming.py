"""videopose3d_torch.streaming against videopose3d_tpu.streaming on seeded numpy
inputs and identical weights: the per-layer engines (float32, bfloat16, int8)
per frame and k frames per step, the warm-ups, the ring push (K7), the
lifters, the streaming CLI, and the streamed poses against the port's own
offline causal model.  Every run steps max(cap) + 3 frames or more, so every
ring wraps.

Tolerances (``torch_port_helpers``): float32 1e-5 and bfloat16 1.6e-2 of
max(1, max |want|); int8 streams within one step on at most 1e-3 of their
elements and poses within 1e-3 across packages (XLA's fused multiply-adds on
the CPU), bitwise within the port.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu import streaming as js
from videopose3d_tpu.datasets.custom import CustomDataset as JaxCustomDataset
from videopose3d_torch import streaming as ts
from videopose3d_torch.datasets.custom import CustomDataset
from videopose3d_torch.evaluate import full_float32
from videopose3d_torch.models.convert import stream_state_from_jax, stream_state_to_jax
from videopose3d_torch.models.temporal import (forward_dilated, forward_dilated_int8,
                                                receptive_field)
from videopose3d_torch.ops.kernels import streaming_fused as sf

from test_e2e_streaming import wild_setup  # noqa: F401  (fixture)
from torch_port_helpers import (INT8_POSE_TOL, STREAM_TOL, assert_close, assert_states_agree,
                                quantized_pair, stream_models, to_jax_state)

ARCHS = [((3, 3, 3), 32, 3), ((3, 5, 5), 16, 2)]   # widths, channels, streams


def _frames(rng, b, k=None):
    shape = (b, 17, 2) if k is None else (b, k, 17, 2)
    return rng.standard_normal(shape).astype(np.float32)


def _n_frames(cfg):
    return max(js._buffer_capacities(cfg)) + 3


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("fw,ch,b", ARCHS)
def test_float_engine_matches_jax(dt, fw, ch, b):
    """stream_step at float32 and bfloat16: poses every frame, rings and ptr at
    the end, against the JAX engine stepped from the same warm-up."""
    cfg, params, state, tcfg, model = stream_models(fw, ch, dt)
    rng = np.random.default_rng(1)
    first = _frames(rng, b)
    jss = js.init_stream_state(cfg, params, state, jnp.asarray(first))
    pss = ts.init_stream_state(tcfg, model, torch.from_numpy(first))
    assert_states_agree(pss, jss)
    w = ts.prepare_stream_weights(tcfg, model)
    for t in range(_n_frames(cfg)):
        frame = _frames(rng, b)
        want, jss = js.stream_step(cfg, params, state, jss, jnp.asarray(frame))
        got, pss = ts.stream_step(tcfg, w, pss, torch.from_numpy(frame))
        assert got.shape == (b, 17, 3) and got.dtype == torch.float32
        assert_close(got, want, STREAM_TOL[dt], f"frame {t}")
    assert_states_agree(pss, jss)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_float_multi_engine_matches_jax(dt):
    cfg, params, state, tcfg, model = stream_models((3, 3, 3), 32, dt, seed=3)
    rng = np.random.default_rng(2)
    b, k = 3, 4
    first = _frames(rng, b)
    jss = js.init_stream_state_multi(cfg, params, state, jnp.asarray(first), k)
    pss = ts.init_stream_state_multi(tcfg, model, torch.from_numpy(first), k)
    assert_states_agree(pss, jss)
    w = ts.prepare_stream_weights(tcfg, model)
    for t in range(_n_frames(cfg) // k + 2):
        frames = _frames(rng, b, k)
        want, jss = js.stream_step_multi(cfg, params, state, jss, jnp.asarray(frames))
        got, pss = ts.stream_step_multi(tcfg, w, pss, torch.from_numpy(frames))
        assert got.shape == (b, k, 17, 3)
        assert_close(got, want, STREAM_TOL[dt], f"step {t}")
    assert_states_agree(pss, jss)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("fw,ch,b", ARCHS)
def test_int8_engines_match_jax(k, fw, ch, b):
    """The per-layer w8a8 engine per frame (k = 1) and k frames per step, on one
    quantized model (q_from_jax)."""
    cfg, params, state, tcfg, _ = stream_models(fw, ch)
    q, tq = quantized_pair(cfg, params, state)
    rng = np.random.default_rng(3)
    first = _frames(rng, b)
    if k == 1:
        jss = js.init_stream_state_int8(cfg, q, jnp.asarray(first))
        pss = ts.init_stream_state_int8(tcfg, tq, torch.from_numpy(first))
        j_step, p_step, n = js.stream_step_int8, ts.stream_step_int8, _n_frames(cfg)
    else:
        jss = js.init_stream_state_int8_multi(cfg, q, jnp.asarray(first), k)
        pss = ts.init_stream_state_int8_multi(tcfg, tq, torch.from_numpy(first), k)
        j_step, p_step = js.stream_step_int8_multi, ts.stream_step_int8_multi
        n = _n_frames(cfg) // k + 2
    assert_states_agree(pss, jss)
    for t in range(n):
        frames = _frames(rng, b, None if k == 1 else k)
        want, jss = j_step(cfg, q, jss, jnp.asarray(frames))
        got, pss = p_step(tcfg, tq, pss, torch.from_numpy(frames))
        assert_close(got, want, INT8_POSE_TOL, f"step {t}")
    assert_states_agree(pss, jss)


def test_state_converts_both_ways():
    cfg, params, state, tcfg, model = stream_models((3, 3, 3), 16, "bfloat16")
    first = _frames(np.random.default_rng(4), 2)
    jss = js.init_stream_state_multi(cfg, params, state, jnp.asarray(first), 2)
    port = stream_state_from_jax(jax.tree_util.tree_map(np.asarray, jss))
    assert [b.dtype for b in port["bufs"]] == [torch.bfloat16] * 3
    assert port["ptr"] == [0, 0, 0]
    back = to_jax_state(port, jss)
    for a, b in zip(back["bufs"], jss["bufs"]):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))
    assert stream_state_to_jax(port)["ptr"].dtype == np.int32


@pytest.mark.parametrize("dt,b,c", [(torch.bfloat16, 4, 32), (torch.float32, 4, 32),
                                    (torch.float32, 1, 30), (torch.bfloat16, 3, 5)])
def test_ring_push_matches_jax_dma(dt, b, c):
    """K7's plain version against the JAX DMA push in interpret mode: bitwise, for
    rows of whole 16-byte words and rows that are not (120 and 30 bytes)."""
    rng = np.random.default_rng(5)
    cap = 7
    buf = rng.standard_normal((cap, b, c)).astype(np.float32)
    row = rng.standard_normal((b, c)).astype(np.float32)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dt]
    for ptr in (0, 5, 13):
        want = js._ring_push_dma(jnp.asarray(buf, jdt), jnp.int32(ptr), cap,
                                 jnp.asarray(row, jdt))
        got = sf.ring_push(torch.from_numpy(buf).to(dt), ptr % cap,
                           torch.from_numpy(row).to(dt))
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_dma_ring_impl_equals_dus():
    """stream_step with the block rings written by ring_push ("dma") gives the
    bits of the plain write ("dus"), as the JAX engine's "dma" does."""
    cfg, params, state, tcfg, model = stream_models((3, 3, 3), 16, "bfloat16")
    rng = np.random.default_rng(6)
    first = _frames(rng, 2)
    w = ts.prepare_stream_weights(tcfg, model)
    a = ts.init_stream_state(tcfg, model, torch.from_numpy(first))
    b = {"bufs": [r.clone() for r in a["bufs"]], "ptr": list(a["ptr"])}
    jss = js.init_stream_state(cfg, params, state, jnp.asarray(first))
    for _ in range(_n_frames(cfg)):
        frame = _frames(rng, 2)
        pa, a = ts.stream_step(tcfg, w, a, torch.from_numpy(frame))
        pb, b = ts.stream_step(tcfg, w, b, torch.from_numpy(frame), _ring_impl="dma")
        want, jss = js.stream_step(cfg, params, state, jss, jnp.asarray(frame),
                                   _ring_impl="dma")
        assert torch.equal(pa, pb)
        assert_close(pb, want, STREAM_TOL["bfloat16"])
    assert all(torch.equal(x, y) for x, y in zip(a["bufs"], b["bufs"]))


def _padded_sequence(cfg, frames):
    """(N, B, J, 2) frames -> (B, 2*pad + N, J, 2): the offline causal input,
    edge-padded like UnchunkedBatcher with causal_shift = pad."""
    pad = (receptive_field(cfg) - 1) // 2
    seq = np.transpose(frames, (1, 0, 2, 3))
    return np.concatenate([np.repeat(seq[:, :1], 2 * pad, axis=1), seq], axis=1)


@pytest.mark.parametrize("fw", [(3, 3), (3, 3, 3), (5, 3)])
def test_streamed_f32_matches_offline_causal(fw):
    """The lifter's float32 stream equals the port's offline causal model over
    the edge-padded sequence (2e-5, the JAX package's bound)."""
    _, _, _, tcfg, model = stream_models(fw, 32)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((20, 3, 17, 2)).astype(np.float32)
    want = forward_dilated(model, torch.from_numpy(_padded_sequence(tcfg, frames)))
    lifter = ts.StreamingCausalLifter(tcfg, model, device="cpu")
    lifter.reset(frames[0])
    got = torch.stack([lifter.step(f) for f in frames], dim=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("engine,k", [("int8", 1), ("int8_fused", 1), ("int8_fused", 4)])
def test_int8_stream_matches_offline_int8(engine, k):
    """The int8 stream (per frame and k frames) equals the port's offline int8
    causal path (forward_dilated_int8) on the same quantized model: equal int8
    streams, the shrink's float32 sums in another order."""
    _, _, _, tcfg, model = stream_models((3, 3, 3), 32, seed=8)
    rng = np.random.default_rng(8)
    frames = rng.standard_normal((24, 3, 17, 2)).astype(np.float32)
    padded = torch.from_numpy(_padded_sequence(tcfg, frames))
    from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
    q = quantize_temporal_model(tcfg, model, padded)
    want = forward_dilated_int8(tcfg, q, padded)
    lifter = ts.StreamingCausalLifter(tcfg, engine=engine, quantized=q,
                                      frames_per_step=k, device="cpu")
    lifter.reset(frames[0])
    seq = np.transpose(frames, (1, 0, 2, 3))
    if k == 1:
        got = torch.stack([lifter.step(f) for f in frames], dim=1)
    else:
        got = torch.cat([lifter.step(seq[:, t:t + k]) for t in range(0, 24, k)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_multi_device_lifter_equals_one_device():
    """Two stream groups on two CPU devices give the single lifter's bits."""
    _, _, _, tcfg, model = stream_models((3, 3, 3), 16)
    rng = np.random.default_rng(9)
    frames = rng.standard_normal((10, 4, 17, 2)).astype(np.float32)
    one = ts.StreamingCausalLifter(tcfg, model, device="cpu")
    two = ts.MultiDeviceStreamingLifter(tcfg, model, devices=["cpu", "cpu"])
    one.reset(frames[0])
    two.reset(frames[0])
    for f in frames:
        want = one.step(f)
        got = two.step(f)
        assert len(got) == 2 and torch.equal(torch.cat(got), want)


def test_validation_errors():
    cfg, params, state, tcfg, model = stream_models((3, 3, 3), 16)
    first = torch.zeros(2, 17, 2)
    import dataclasses
    with pytest.raises(ValueError, match="causal"):
        ts.init_stream_state(dataclasses.replace(tcfg, causal=False), model, first)
    with pytest.raises(ValueError, match="mixed"):
        ts.StreamingCausalLifter(dataclasses.replace(tcfg, compute_dtype="mixed"), model,
                                 device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        ts.StreamingCausalLifter(tcfg, model, engine="bf16_fused", device="cpu")
    with pytest.raises(ValueError, match="unknown streaming engine"):
        ts.StreamingCausalLifter(tcfg, model, engine="fp8", device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        ts.StreamingCausalLifter(tcfg, engine="int8", device="cpu")
    with pytest.raises(ValueError, match="params and state"):
        ts.StreamingCausalLifter(tcfg, engine="bf16", device="cpu")
    with pytest.raises(ValueError, match="frames_per_step"):
        ts.StreamingCausalLifter(tcfg, model, frames_per_step=0, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts.StreamingCausalLifter(tcfg, model, mesh=["cpu"], device="cpu")
    w = ts.prepare_stream_weights(tcfg, model)
    multi = ts.init_stream_state_multi(tcfg, model, first, 2)
    with pytest.raises(ValueError, match="capacities"):
        ts.stream_step(tcfg, w, multi, first)
    with pytest.raises(ValueError, match="frames_per_step=4"):
        ts.stream_step_multi(tcfg, w, multi, torch.zeros(2, 4, 17, 2))
    lifter = ts.MultiDeviceStreamingLifter(tcfg, model, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="split evenly"):
        lifter.reset(np.zeros((3, 17, 2), np.float32))
    # The JAX package raises the same errors on the same misuse.
    with pytest.raises(ValueError, match="capacities"):
        js.stream_step(cfg, params, state, js.init_stream_state_multi(
            cfg, params, state, jnp.zeros((2, 17, 2)), 2), jnp.zeros((2, 17, 2)))


def test_custom_dataset_matches_jax(wild_setup):  # noqa: F811
    data_dir = wild_setup[0]
    path = f"{data_dir}/data_2d_custom_myvideos.npz"
    got, want = CustomDataset(path), JaxCustomDataset(path)
    assert list(got.subjects()) == list(want.subjects())
    assert got.skeleton().num_joints() == want.skeleton().num_joints() == 17
    assert np.array_equal(got.skeleton().parents(), want.skeleton().parents())
    assert got.skeleton().joints_left() == want.skeleton().joints_left()
    for video in want.subjects():
        g, w = got.cameras()[video][0], want.cameras()[video][0]
        assert g.keys() == w.keys()
        for key in w:
            assert np.array_equal(np.asarray(g[key]), np.asarray(w[key])), key
    videos, streams = ts._load_wild_streams(data_dir, "myvideos")
    jv, jstreams = js._load_wild_streams(data_dir, "myvideos")
    assert videos == jv
    assert all(np.array_equal(a, b) for a, b in zip(streams, jstreams))


# ---------------------------------------------------------------------------
# The streaming CLI against the JAX package's
# ---------------------------------------------------------------------------


def _cli(data_dir, ckpt, out, *extra):
    return ["-k", "myvideos", "--data-dir", data_dir, "--checkpoint", ckpt,
            "-arc", "3,3,3", "-ch", "16", "--output", out, *extra]


def _info(text):
    return [line for line in text.splitlines() if line.startswith("INFO: streaming ")]


# engine, compute dtype, frames per step.  A fused engine is held against the JAX
# per-layer engine of its type, which the JAX package's tests hold bitwise equal to
# its fused kernel (tests/test_e2e_streaming.py).
CLI_CASES = [("bf16", "float32", 1), ("bf16", "bfloat16", 1),
             ("bf16_fused", "bfloat16", 1), ("int8", "float32", 1),
             ("int8_fused", "float32", 1), ("bf16", "float32", 4),
             ("bf16_fused", "bfloat16", 4), ("int8_fused", "float32", 4)]


@pytest.mark.parametrize("engine,dt,k", CLI_CASES)
def test_streaming_cli_matches_jax(wild_setup, tmp_path, capsys, engine, dt, k):  # noqa: F811
    data_dir, ckpt, *_ = wild_setup
    extra = ["--compute-dtype", dt, "--frames-per-step", str(k)]
    js.main(_cli(data_dir, ckpt, str(tmp_path / "jax.npz"), "--engine",
                 engine.replace("_fused", ""), *extra))
    jax_out = capsys.readouterr().out
    ts.main(_cli(data_dir, ckpt, str(tmp_path / "port.npz"), "--engine", engine,
                 "--device", "cpu", *extra))
    port_out = capsys.readouterr().out
    assert _info(port_out) == [line.replace(engine.replace("_fused", ""), engine)
                               for line in _info(jax_out)]
    assert "INFO: streamed 65 frames" in port_out
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files) == ["clip_a.mp4", "clip_b.mp4"]
    tol = INT8_POSE_TOL if engine.startswith("int8") else STREAM_TOL[dt]
    for video in want.files:
        assert got[video].shape == want[video].shape == (want[video].shape[0], 17, 3)
        assert_close(got[video], want[video], tol, video)


def test_streaming_cli_video_subset_and_shards(wild_setup, tmp_path, capsys):  # noqa: F811
    """--videos against the JAX CLI; --shard-devices 3 over 2 videos (padding)
    gives the one-device poses; python -m runs the CLI to the in-process bits."""
    data_dir, ckpt, *_ = wild_setup
    js.main(_cli(data_dir, ckpt, str(tmp_path / "jax.npz"), "--videos", "clip_b.mp4"))
    ts.main(_cli(data_dir, ckpt, str(tmp_path / "port.npz"), "--videos", "clip_b.mp4",
                 "--device", "cpu"))
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert got.files == ["clip_b.mp4"] and got["clip_b.mp4"].shape == (25, 17, 3)
    assert_close(got["clip_b.mp4"], want["clip_b.mp4"], STREAM_TOL["float32"])
    with pytest.raises(KeyError):
        ts.main(_cli(data_dir, ckpt, str(tmp_path / "x.npz"), "--videos", "nope.mp4",
                     "--device", "cpu"))

    one = ["--engine", "int8_fused", "--device", "cpu"]
    ts.main(_cli(data_dir, ckpt, str(tmp_path / "one.npz"), *one))
    ts.main(_cli(data_dir, ckpt, str(tmp_path / "sh.npz"), *one, "--shard-devices", "3"))
    assert "sharding 3 streams (1 padding) over 3 local devices" in capsys.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "videopose3d_torch.streaming",
         *_cli(data_dir, ckpt, str(tmp_path / "m.npz"), *one)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "engine int8_fused" in proc.stdout
    a, b, c = (np.load(tmp_path / n) for n in ("one.npz", "sh.npz", "m.npz"))
    for video in a.files:
        # One stream per group: the shrink's float32 sums run over fewer rows.
        assert_close(b[video], a[video], STREAM_TOL["float32"], video)
        assert np.array_equal(a[video], c[video])

    with pytest.raises(SystemExit):
        ts.main(_cli(data_dir, ckpt, str(tmp_path / "x.npz"), "--engine", "bf16_fused",
                     "--device", "cpu"))


def test_streaming_cli_device_cuda_raises_without_a_card(wild_setup, tmp_path):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data_dir, ckpt, *_ = wild_setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.main(_cli(data_dir, ckpt, str(tmp_path / "x.npz")))


def test_full_float32_is_restored_after_a_step():
    """The engines turn TF32 off only inside a step."""
    _, _, _, tcfg, model = stream_models((3, 3, 3), 16)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lifter = ts.StreamingCausalLifter(tcfg, model, device="cpu")
        lifter.reset(np.zeros((2, 17, 2), np.float32))
        lifter.step(np.zeros((2, 17, 2), np.float32))
        assert torch.backends.cuda.matmul.allow_tf32
        with full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
