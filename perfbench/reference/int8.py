"""w8a8 integer serving of the temporal model in plain PyTorch: calibration, the
quantization of weights and activations, and the integer forward, at any
``qmax`` (127: int8; 7: int4, a control's precision).

The scheme the configuration states (``"serving": "w8a8"``): weights symmetric per
output channel with the input stream's static per-channel scale folded in; the
residual stream non-negative in 0..qmax with a static per-channel scale from a
calibration forward (per-channel absmax, floored at half the layer's largest and
widened by 1.25); inside a block the mid activation requantized per row to
0..qmax by its row maximum; integer products summed exactly; the expand's and the
shrink's products in bfloat16.  Every float step is one IEEE operation in the
order written, so that two exact implementations give the same integers.
"""

from __future__ import annotations

import torch

from perfbench.reference import model as ref

MARGIN, FLOOR_FRAC = 1.25, 0.5


def _div(a, b: float):
    """``a / b`` as an IEEE division for a scalar ``b``."""
    return a / torch.full_like(a, b)


def _fold(w, name):
    scale = w[f"{name}.weight"].float() * torch.rsqrt(w[f"{name}.running_var"].float()
                                                       + ref.BN_EPS)
    return scale, w[f"{name}.bias"].float() - w[f"{name}.running_mean"].float() * scale


def _last(conv_w, dt):
    """(C_out, C_in, k) -> channels-last (k, C_in, C_out) in ``dt``."""
    return conv_w.permute(2, 1, 0).to(dt).contiguous()


def _conv_f32(x, conv_w, dilation: int):
    w = _last(conv_w, torch.float32)
    k = w.shape[0]
    t_out = x.shape[1] - (k - 1) * dilation
    taps = torch.cat([x[:, j * dilation: j * dilation + t_out] for j in range(k)], dim=-1)
    return taps @ w.reshape(-1, w.shape[-1])


@torch.no_grad()
def calibrate(w, cfg, x_calib):
    """Per-channel absmax of the expand output, and per block of the mid
    activation and the output stream, over a float32 forward (TF32 off)."""
    with ref.precision(False):
        x = x_calib.float().reshape(x_calib.shape[0], x_calib.shape[1], -1)
        absmax = lambda v: torch.clamp_min(v.abs().amax(dim=(0, 1)), 1e-6)
        s0, b0 = _fold(w, "expand_bn")
        x = torch.relu(_conv_f32(x, w["expand_conv.weight"], 1) * s0 + b0)
        caps = {"expand": absmax(x), "h": [], "stream": []}
        ds, ps = ref.dilations(cfg), ref.pads(cfg)
        for i in range(len(cfg["filter_widths"]) - 1):
            pad = ps[i + 1]
            shift = pad if cfg["causal"] else 0
            res = x[:, pad + shift: x.shape[1] - pad + shift]
            s1, b1 = _fold(w, f"layers_bn.{2 * i}")
            s2, b2 = _fold(w, f"layers_bn.{2 * i + 1}")
            h = torch.relu(_conv_f32(x, w[f"layers_conv.{2 * i}.weight"], ds[i + 1]) * s1 + b1)
            caps["h"].append(absmax(h))
            y = torch.relu(_conv_f32(h, w[f"layers_conv.{2 * i + 1}.weight"], 1) * s2 + b2)
            x = res + y
            caps["stream"].append(absmax(x))
    return caps


def _per_channel(w_eff, qmax):
    dims = tuple(range(w_eff.ndim - 1))
    scale = _div(torch.clamp_min(w_eff.abs().amax(dim=dims), 1e-8), qmax)
    return torch.clamp(torch.round(w_eff / scale), -qmax, qmax), scale.float()


@torch.no_grad()
def quantize(w, cfg, x_calib, qmax: float = 127.0):
    """The integer model: {"expand": (w (k*C_in, C) bf16, scale, shift),
    "blocks": [(wq_a (k, C, C), wq_b (C, C), a1, b1, a2, b2, r)], "shrink":
    (w (C, J3) bf16, bias)}, integer weights held as float64."""
    caps = calibrate(w, cfg, x_calib)
    widen = lambda v: torch.maximum(v, FLOOR_FRAC * v.max()) * MARGIN
    v0 = widen(caps["expand"])
    h_caps = [widen(v) for v in caps["h"]]
    out_caps = [widen(v) for v in caps["stream"]]
    n_blocks = len(cfg["filter_widths"]) - 1
    blocks, v_in = [], v0
    for i in range(n_blocks):
        s1, b1 = _fold(w, f"layers_bn.{2 * i}")
        s2, b2 = _fold(w, f"layers_bn.{2 * i + 1}")
        h_max, v_out = h_caps[i], out_caps[i]
        wa = _last(w[f"layers_conv.{2 * i}.weight"], torch.float32)
        wq_a, sc_a = _per_channel(wa * _div(v_in, qmax)[None, :, None], qmax)
        wb = _last(w[f"layers_conv.{2 * i + 1}.weight"], torch.float32)[0]
        wq_b, sc_b = _per_channel(wb * _div(h_max, qmax)[:, None], qmax)
        a1, b1q = sc_a * s1 * qmax / h_max, b1 * qmax / h_max
        if i == n_blocks - 1:
            a2, b2q, r = sc_b * s2, b2, _div(v_in, qmax)
        else:
            a2, b2q, r = sc_b * s2 * qmax / v_out, b2 * qmax / v_out, v_in / v_out
        blocks.append((wq_a.double(), wq_b.double(),
                       *(v.float() for v in (a1, b1q, a2, b2q, r))))
        v_in = v_out
    s0, b0 = _fold(w, "expand_bn")
    ew = _last(w["expand_conv.weight"], torch.bfloat16)
    return {"qmax": qmax,
            "expand": (ew.reshape(-1, ew.shape[-1]), (s0 * qmax / v0).float(),
                       (b0 * qmax / v0).float()),
            "blocks": blocks,
            "shrink": (_last(w["shrink.weight"], torch.bfloat16)[0],
                       w["shrink.bias"].float())}


@torch.no_grad()
def forward(qm, cfg, x):
    """Integer forward: (R, T, J_in, F) keypoints -> (R, T - rf + 1, J_out, 3)
    float32 poses."""
    qmax = qm["qmax"]
    to_stream = lambda v: torch.clamp(torch.round(v), 0.0, qmax)
    k0 = cfg["filter_widths"][0]
    x = x.reshape(x.shape[0], x.shape[1], -1)
    t_e = x.shape[1] - (k0 - 1)
    taps = torch.cat([x[:, j: j + t_e] for j in range(k0)], dim=-1).to(torch.bfloat16)
    ew, scale, shift = qm["expand"]
    e = (taps.double() @ ew.double()).float()
    s = to_stream(torch.relu(e * scale + shift))
    ds, ps = ref.dilations(cfg), ref.pads(cfg)
    n_blocks = len(qm["blocks"])
    for i, (wq_a, wq_b, a1, b1, a2, b2, r) in enumerate(qm["blocks"]):
        d, k = ds[i + 1], wq_a.shape[0]
        t_out = s.shape[1] - (k - 1) * d
        off = ps[i + 1] + (ps[i + 1] if cfg["causal"] else 0)
        acc = s[:, :t_out].double() @ wq_a[0]
        for j in range(1, k):
            acc = acc + s[:, j * d: j * d + t_out].double() @ wq_a[j]
        real = torch.relu(acc.float() * a1 + b1)
        rowmax = torch.clamp_min(real.amax(dim=-1, keepdim=True), 1.0)
        hq = torch.round(real * (torch.full_like(rowmax, qmax) / rowmax))
        y = torch.relu((hq.double() @ wq_b).float() * (rowmax * (1.0 / qmax)) * a2 + b2)
        out = s[:, off: off + t_out].float() * r + y
        s = out if i == n_blocks - 1 else to_stream(out)
    sw, sb = qm["shrink"]
    poses = s.to(torch.bfloat16).float() @ sw.float() + sb
    return poses.reshape(poses.shape[0], poses.shape[1], -1, 3)
