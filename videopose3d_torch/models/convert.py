"""Weight-layout conversion between the JAX package's parameter pytrees and the
port's state dict.

The JAX package keeps convolution weights as ``(k, C_in, C_out)`` in nested
``params`` / ``state`` dicts; ``TemporalModel`` keeps ``nn.Conv1d`` weights as
``(C_out, C_in, k)`` under the reference state-dict keys.  These are numpy-only
counterparts of ``videopose3d_tpu.models.convert.params_to_torch_state_dict``
and ``params_from_torch_state_dict``: feed them dicts of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np


def _swap_conv_layout(w) -> np.ndarray:
    """(k, C_in, C_out) <-> (C_out, C_in, k)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0)))


def state_dict_from_jax(params, state) -> Dict[str, np.ndarray]:
    """JAX ``(params, state)`` -> a ``TemporalModel`` state dict of numpy arrays."""
    sd: Dict[str, np.ndarray] = {
        "expand_conv.weight": _swap_conv_layout(params["expand_conv"]["weight"]),
        "expand_bn.weight": np.asarray(params["expand_bn"]["scale"]),
        "expand_bn.bias": np.asarray(params["expand_bn"]["bias"]),
        "expand_bn.running_mean": np.asarray(state["expand_bn"]["mean"]),
        "expand_bn.running_var": np.asarray(state["expand_bn"]["var"]),
        "shrink.weight": _swap_conv_layout(params["shrink"]["weight"]),
        "shrink.bias": np.asarray(params["shrink"]["bias"]),
    }
    for i, conv in enumerate(params["layers_conv"]):
        sd[f"layers_conv.{i}.weight"] = _swap_conv_layout(conv["weight"])
    for i, (bn_p, bn_s) in enumerate(zip(params["layers_bn"], state["layers_bn"])):
        sd[f"layers_bn.{i}.weight"] = np.asarray(bn_p["scale"])
        sd[f"layers_bn.{i}.bias"] = np.asarray(bn_p["bias"])
        sd[f"layers_bn.{i}.running_mean"] = np.asarray(bn_s["mean"])
        sd[f"layers_bn.{i}.running_var"] = np.asarray(bn_s["var"])
    return sd


def jax_params_from_state_dict(
        sd: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A reference-layout state dict -> JAX ``(params, state)`` of numpy arrays
    (the inverse of :func:`state_dict_from_jax`)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    n_layers = sum(1 for k in sd if k.startswith("layers_conv.") and k.endswith(".weight"))
    f32 = lambda key: sd[key].astype(np.float32)
    params = {
        "expand_conv": {"weight": _swap_conv_layout(sd["expand_conv.weight"])},
        "expand_bn": {"scale": f32("expand_bn.weight"), "bias": f32("expand_bn.bias")},
        "layers_conv": [{"weight": _swap_conv_layout(sd[f"layers_conv.{i}.weight"])}
                        for i in range(n_layers)],
        "layers_bn": [{"scale": f32(f"layers_bn.{i}.weight"),
                       "bias": f32(f"layers_bn.{i}.bias")} for i in range(n_layers)],
        "shrink": {"weight": _swap_conv_layout(sd["shrink.weight"]),
                   "bias": f32("shrink.bias")},
    }
    state = {
        "expand_bn": {"mean": f32("expand_bn.running_mean"),
                      "var": f32("expand_bn.running_var")},
        "layers_bn": [{"mean": f32(f"layers_bn.{i}.running_mean"),
                       "var": f32(f"layers_bn.{i}.running_var")}
                      for i in range(n_layers)],
    }
    return params, state


def _tensor(v, device, dtype=None):
    """A numpy leaf of the JAX package as a torch tensor of its own memory (the
    port writes rings in place); a bfloat16 leaf (ml_dtypes) carries its bits
    through float32."""
    import torch
    v = np.array(v)
    if v.dtype.name == "bfloat16":
        v, dtype = v.astype(np.float32), torch.bfloat16
    return torch.from_numpy(v).to(device, dtype)


def stream_state_from_jax(stream_state, device="cpu"):
    """A JAX streaming state (``init_stream_state*``'s pytree, leaves as numpy)
    -> the port's: the rings as tensors on ``device``, ``ptr`` as host ints."""
    return {"bufs": [_tensor(b, device) for b in stream_state["bufs"]],
            "ptr": [int(p) for p in np.asarray(stream_state["ptr"])]}


def stream_state_to_jax(stream_state):
    """The inverse of :func:`stream_state_from_jax`, leaves as numpy: bfloat16
    rings come back as float32 holding their exact values (cast them to the JAX
    state's dtype), ``ptr`` as an int32 array."""
    import torch
    return {"bufs": [(b.float() if b.dtype == torch.bfloat16 else b).cpu().numpy()
                     for b in stream_state["bufs"]],
            "ptr": np.asarray(stream_state["ptr"], np.int32)}


def q_from_jax(q, device="cpu"):
    """The JAX package's int8 serving pytree (``quantize_temporal_model``'s
    output, leaves as numpy) -> the port's ``QuantizedModel`` on ``device``,
    the int8 kernels' weight packing included, so both packages can serve one
    quantized model."""
    import torch
    from videopose3d_torch.ops.kernels.temporal_block_int8 import (Int8Block,
                                                                    QuantizedModel)

    def t(v, dtype=None):
        return _tensor(v, device, dtype)

    blocks = [Int8Block(t(b["wq_a"]), t(b["wq_b"]),
                        *(t(b[k], torch.float32) for k in ("A1", "B1", "A2", "B2", "R")))
              for b in q["blocks"]]
    return QuantizedModel(
        expand_w=t(q["expand_w"], torch.bfloat16),
        expand_scale=t(q["expand_scale"], torch.float32),
        expand_shift=t(q["expand_shift"], torch.float32), blocks=blocks,
        shrink_w=t(q["shrink_w"], torch.bfloat16),
        shrink_b=t(q["shrink_b"], torch.float32))


def jax_params_from_model(model, optimizer=None):
    """A ``TemporalModel``'s JAX ``(params, state)`` of numpy arrays; with its
    ``torch.optim.Adam(amsgrad=True)`` optimizer also the AMSGrad moments
    ``{"m", "v", "vmax"}`` as params-shaped trees (zeros before the first step),
    the layout of the JAX package's ``scale_by_torch_amsgrad`` state."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, state = jax_params_from_state_dict(sd)
    if optimizer is None:
        return params, state
    moments = {}
    for ours, torch_key in (("m", "exp_avg"), ("v", "exp_avg_sq"),
                            ("vmax", "max_exp_avg_sq")):
        tree = dict(sd)
        for name, p in model.named_parameters():
            value = optimizer.state.get(p, {}).get(torch_key)
            tree[name] = (np.zeros(tuple(p.shape), np.float32) if value is None
                          else value.detach().cpu().numpy())
        moments[ours] = jax_params_from_state_dict(tree)[0]
    return params, state, moments
