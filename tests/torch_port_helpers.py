"""Shared inputs for the tests that hold videopose3d_torch against videopose3d_tpu:
seeded numpy weights and data handed to both packages."""

import numpy as np
import torch

H36M_KPS_LEFT = [4, 5, 6, 11, 12, 13]
H36M_KPS_RIGHT = [1, 2, 3, 14, 15, 16]


def jax_model(cfg_kwargs, seed=0, randomize_bn=True):
    """A JAX (config, params, state) with random BatchNorm statistics, and the
    port's TemporalModel carrying the same weights (eval mode)."""
    import jax
    from videopose3d_tpu.models.temporal import (TemporalModelConfig,
                                                 init_temporal_model)
    from videopose3d_torch.models.convert import state_dict_from_jax
    from videopose3d_torch.models.temporal import (
        TemporalModel, TemporalModelConfig as TorchConfig)

    cfg = TemporalModelConfig(**cfg_kwargs)
    params, state = init_temporal_model(cfg, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    if randomize_bn:
        rng = np.random.default_rng(seed + 100)
        for bn_p, bn_s in zip([params["expand_bn"], *params["layers_bn"]],
                              [state["expand_bn"], *state["layers_bn"]]):
            c = bn_p["scale"].shape[0]
            bn_p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            bn_p["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
            bn_s["mean"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
            bn_s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    tcfg = TorchConfig(**cfg_kwargs)
    model = TemporalModel(tcfg)
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                           state_dict_from_jax(params, state).items()})
    return cfg, params, state, tcfg, model.eval()


def write_h36m_archives(root, subjects=("S9", "S11"),
                        actions=("Walking 1", "Eating 2"), n_frames=60, seed=0):
    """Synthetic data_3d_h36m.npz / data_2d_h36m_gt.npz in the reference format."""
    rng = np.random.default_rng(seed)
    p3 = {s: {a: (rng.standard_normal((n_frames, 1, 3)) * 0.1
                  + rng.standard_normal((n_frames, 32, 3)) * 0.2).astype(np.float32)
              for a in actions} for s in subjects}
    np.savez_compressed(f"{root}/data_3d_h36m.npz", positions_3d=p3)
    p2 = {s: {a: [rng.uniform(100, 900, (n_frames, 17, 2)).astype(np.float32)
                  for _ in range(4)] for a in actions} for s in subjects}
    meta = {"layout_name": "h36m", "num_joints": 17,
            "keypoints_symmetry": [H36M_KPS_LEFT, H36M_KPS_RIGHT]}
    np.savez_compressed(f"{root}/data_2d_h36m_gt.npz", positions_2d=p2,
                        metadata=meta)


def protocol_numbers(text):
    """{action: [P1, P2, P3, MPJVE]} from the printed per-action reports."""
    import re
    out, action = {}, None
    for line in text.splitlines():
        m = re.match(r"^----([^-].*)----$", line)
        if m:
            action = m.group(1)
            out[action] = []
            continue
        m = re.match(r"^(?:Protocol #\d Error|Velocity Error) \(\S+\): (\S+) mm$", line)
        if m and action is not None:
            out[action].append(float(m.group(1)))
    return out


def average_lines(text):
    """The four printed action-wise average lines."""
    return [line for line in text.splitlines() if "action-wise average" in line]


# ---------------------------------------------------------------------------
# Streaming: tolerances and comparisons shared by tests/test_torch_streaming*.py
# ---------------------------------------------------------------------------

# Port vs JAX, max |got - want| <= tol * max(1, max |want|) per tensor.  float32:
# the same float32 products summed in another order (~1e-7 measured).  bfloat16:
# one bf16 step (2^-8 relative) at the largest value, where another summation
# order moves a float32 sum across a bf16 rounding point.
STREAM_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# int8 streams: XLA on the CPU contracts the epilogues' ``a * s + b`` into one
# fused multiply-add where torch rounds twice, which flips a rounding of the int8
# stream only at a tie: at most one step on at most 1e-3 of the elements; the
# poses within 1e-3 * max(1, max |JAX|).
INT8_STREAM_FRAC = 1e-3
INT8_POSE_TOL = 1e-3


def stream_models(fw, channels, compute_dtype="float32", seed=0):
    """A causal JAX model and the port's copy: (cfg, params, state, tcfg, model)."""
    return jax_model(dict(num_joints_in=17, in_features=2, num_joints_out=17,
                          filter_widths=fw, causal=True, channels=channels,
                          compute_dtype=compute_dtype), seed=seed)


def quantized_pair(cfg, params, state, seed=0):
    """The JAX int8 pytree calibrated on seeded frames, and the port's copy."""
    import jax
    import jax.numpy as jnp
    from videopose3d_tpu.models.temporal import receptive_field
    from videopose3d_tpu.ops.pallas.temporal_block_int8 import quantize_temporal_model
    from videopose3d_torch.models.convert import q_from_jax
    rng = np.random.default_rng(seed + 50)
    calib = rng.standard_normal((1, receptive_field(cfg) + 64, 17, 2)).astype(np.float32)
    q = quantize_temporal_model(cfg, params, state, jnp.asarray(calib))
    return q, q_from_jax(jax.tree_util.tree_map(np.asarray, q))


def to_jax_state(stream_state, like):
    """The port's stream state as a JAX one, the rings in ``like``'s dtypes."""
    import jax.numpy as jnp
    from videopose3d_torch.models.convert import stream_state_to_jax
    ss = stream_state_to_jax(stream_state)
    return {"bufs": [jnp.asarray(b, r.dtype) for b, r in zip(ss["bufs"], like["bufs"])],
            "ptr": jnp.asarray(ss["ptr"])}


def assert_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def assert_int8_agree(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8, what
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= INT8_STREAM_FRAC, (
        what, diff.max(), (diff > 0).mean())


def assert_states_agree(port_state, jax_state):
    """Rings at their dtype's tolerance, positions equal."""
    assert list(port_state["ptr"]) == [int(p) for p in np.asarray(jax_state["ptr"])]
    for i, (p, j) in enumerate(zip(port_state["bufs"], jax_state["bufs"])):
        p = p.cpu()
        if p.dtype == torch.int8:
            assert_int8_agree(p.numpy(), np.asarray(j), f"ring {i}")
        else:
            tol = STREAM_TOL["float32" if p.dtype == torch.float32 else "bfloat16"]
            assert_close(p.float().numpy(), np.asarray(j, np.float32), tol, f"ring {i}")
