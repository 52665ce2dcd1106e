"""MotionBERT's DSTformer: a dual-stream spatial-temporal transformer that lifts
2D keypoint tracks to 3D poses, in PyTorch.

Zhu et al., "MotionBERT: A Unified Perspective on Learning Human Motion
Representations" (ICCV 2023, arXiv:2210.06551); the paper code's
``lib/model/DSTformer.py``.  Parameter names are that code's state-dict keys
(``joints_embed.weight``, ``blocks_st.{l}.attn_s.qkv.weight``,
``ts_attn.{l}.bias``, ...), so its backbone weights load with
``load_state_dict(strict=True)``.

Input ``x`` (B, T, J, dim_in) (x, y, confidence), T <= maxlen; output
(B, T, J, dim_out):

1. ``h = x W_in + b_in + P_s[j] + P_t[t]`` (``pos_embed`` (1, J, C),
   ``temp_embed`` (1, maxlen, 1, C), both learned);
2. for each layer l: ``h_st = ST_l(h)``, ``h_ts = TS_l(h)``, ``alpha =
   softmax([h_st | h_ts] G_l + g_l)`` over its two outputs per token, ``h =
   alpha_0 h_st + alpha_1 h_ts`` (``G_l`` initialised to 0, ``g_l`` to 0.5);
3. ``ST_l`` is four pre-norm residual sub-layers, spatial attention, MLP,
   temporal attention, MLP, each with its own LayerNorm (eps 1e-6) and
   weights; ``TS_l`` the same with the temporal pair first;
4. spatial attention attends among the J joints of one frame, temporal
   attention among the T frames of one joint: ``qkv = Linear(C -> 3C)``,
   heads of C / num_heads, scale ``head_dim ** -0.5``, softmax over keys,
   ``Linear(C -> C)``;
5. ``MLP = Linear(C -> mlp_ratio C) -> GELU (erf) -> Linear(-> C)``;
6. ``y = tanh(LN(h) W_rep + b_rep) W_out + b_out``.

The attention core (scores, softmax, weighted sum) is :class:`AttentionCore`, an
``autograd.Function`` whose backward is written out (``dV = P^T dO``, ``dP = dO
V^T``, ``dS = P * (dP - rowsum(dP * P))``, ``dQ = dS K s``, ``dK = dS^T Q s``):
one seam for a fused kernel, and the home of the ``vp3d.dst.attention.*`` spans.
It takes the token-major ``(B, T, J, 3C)`` output of the qkv projection and gives
``(B, T, J, C)``, so every per-token operation (LayerNorm, the linears, GELU, the
gate) runs in one layout and only the core turns frames or joints into its
batch axis.

Departures from the paper code, none of them in the mathematics:

* no dropout, attention dropout or drop-path: the recipe's rates are 0;
* the residual stream stays ``(B, T, J, C)`` throughout instead of ``(B*T, J,
  C)`` with the temporal attention reshaping it, the same numbers;
* ``forward_clips`` evaluates videos of any length as consecutive clips of
  ``maxlen`` frames, the last edge-padded (the paper code evaluates fixed clips
  cut by its data loader);
* ``init_weights`` draws the truncated normal (std 0.02) at +-2 standard
  deviations, where ``timm``'s ``trunc_normal_`` cuts at +-2 absolute.

Training (``train.SupervisedTrainer``) takes :func:`forward_train` and
:func:`per_sample_loss`: MPJPE + 0.5 N-MPJPE (one scale a frame) + 20 velocity
error on root-relative poses, the recipe of ``configs/pose3d/MB_train_h36m.yaml``;
its optimizer is AdamW (:meth:`DSTformer.optimizer`).  Everything runs in
float32; the CLI holds it under ``evaluate.full_float32()`` (TF32 off).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from videopose3d_torch.profiling import count, span

# What --train-engine pallas would need and the port does not have yet.
MISSING_KERNELS = ("a fused attention core (scores, softmax, weighted sum and their "
                   "backward), LayerNorm, the GELU MLP and the stream gate")


@dataclasses.dataclass(frozen=True)
class DSTformerConfig:
    """The published sizes (MotionBERT, ``MB_train_h36m.yaml``) as defaults."""

    num_joints: int = 17
    dim_in: int = 3
    dim_out: int = 3
    dim_feat: int = 512
    dim_rep: int = 512
    depth: int = 5
    num_heads: int = 8
    mlp_ratio: int = 2
    maxlen: int = 243
    qkv_bias: bool = True
    att_fuse: bool = True
    ln_eps: float = 1e-6
    weight_decay: float = 0.01  # AdamW's, the recipe's

    def __post_init__(self):
        if self.dim_feat % self.num_heads:
            raise ValueError(f"dim_feat {self.dim_feat} is not a multiple of "
                             f"num_heads {self.num_heads}")

    @property
    def compute_dtype(self) -> str:
        """What the evaluator reads off any model's config: float32 throughout."""
        return "float32"


def _split_heads(t, heads: int, axis: str):
    """(B, T, J, H*D) -> the core's layout: (B, T, H, J, D) for spatial
    attention, (B, J, H, T, D) for temporal (a view)."""
    b, f, j, c = t.shape
    t = t.reshape(b, f, j, heads, c // heads)
    return t.permute(0, 1, 3, 2, 4) if axis == "spatial" else t.permute(0, 2, 3, 1, 4)


def _merge_heads(t, axis: str):
    """The inverse of :func:`_split_heads`, as a contiguous (B, T, J, H*D)."""
    t = t.permute(0, 1, 3, 2, 4) if axis == "spatial" else t.permute(0, 3, 1, 2, 4)
    b, f, j, h, d = t.shape
    return t.reshape(b, f, j, h * d)


class AttentionCore(torch.autograd.Function):
    """``softmax(Q K^T s) V`` among the joints of each frame (``axis`` "spatial")
    or the frames of each joint ("temporal"), every head at once.

    ``apply(qkv, heads, axis)``: qkv (B, T, J, 3C), the qkv projection's output
    (its last axis [q | k | v], each head's D = C / heads channels contiguous);
    returns (B, T, J, C).  Keeps qkv and the probabilities for the backward, which
    is written out in plain torch operations.  Its forward and backward run
    inside ``vp3d.dst.attention.<axis>``; a forward counts
    ``dst.attention_<axis>``."""

    @staticmethod
    def forward(ctx, qkv, heads: int, axis: str):
        with span(f"vp3d.dst.attention.{axis}"):
            count(f"dst.attention_{axis}")
            q, k, v = (_split_heads(t, heads, axis) for t in qkv.chunk(3, dim=-1))
            scale = q.shape[-1] ** -0.5
            p = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * scale, dim=-1)
            out = _merge_heads(torch.matmul(p, v), axis)
            ctx.save_for_backward(qkv, p)
            ctx.heads, ctx.axis = heads, axis
            return out

    @staticmethod
    def backward(ctx, d_out):
        axis = ctx.axis
        with span(f"vp3d.dst.attention.{axis}"):
            qkv, p = ctx.saved_tensors
            q, k, v = (_split_heads(t, ctx.heads, axis) for t in qkv.chunk(3, dim=-1))
            scale = q.shape[-1] ** -0.5
            do = _split_heads(d_out, ctx.heads, axis)
            dv = torch.matmul(p.transpose(-2, -1), do)
            dp = torch.matmul(do, v.transpose(-2, -1))
            ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
            dq = torch.matmul(ds, k) * scale
            dk = torch.matmul(ds.transpose(-2, -1), q) * scale
            d_qkv = torch.cat([_merge_heads(g, axis) for g in (dq, dk, dv)], dim=-1)
            return d_qkv, None, None


class Attention(nn.Module):
    """Multi-head self-attention over one axis (the paper code's ``Attention``)."""

    def __init__(self, cfg: DSTformerConfig, axis: str):
        super().__init__()
        self.axis, self.heads = axis, cfg.num_heads
        self.qkv = nn.Linear(cfg.dim_feat, 3 * cfg.dim_feat, bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.dim_feat, cfg.dim_feat)

    def forward(self, x):
        return self.proj(AttentionCore.apply(self.qkv(x), self.heads, self.axis))


class MLP(nn.Module):
    def __init__(self, cfg: DSTformerConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.dim_feat, cfg.mlp_ratio * cfg.dim_feat)
        self.fc2 = nn.Linear(cfg.mlp_ratio * cfg.dim_feat, cfg.dim_feat)

    def forward(self, x):
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class Block(nn.Module):
    """One stream of a layer: ``stage_st`` (spatial pair first) or ``stage_ts``."""

    def __init__(self, cfg: DSTformerConfig, mode: str):
        super().__init__()
        self.mode = mode
        norm = lambda: nn.LayerNorm(cfg.dim_feat, eps=cfg.ln_eps)
        self.norm1_s, self.norm1_t = norm(), norm()
        self.attn_s, self.attn_t = Attention(cfg, "spatial"), Attention(cfg, "temporal")
        self.norm2_s, self.norm2_t = norm(), norm()
        self.mlp_s, self.mlp_t = MLP(cfg), MLP(cfg)

    def forward(self, x):
        pairs = [(self.norm1_s, self.attn_s, self.norm2_s, self.mlp_s),
                 (self.norm1_t, self.attn_t, self.norm2_t, self.mlp_t)]
        if self.mode == "stage_ts":
            pairs.reverse()
        for norm1, attn, norm2, mlp in pairs:
            x = x + attn(norm1(x))
            x = x + mlp(norm2(x))
        return x


class DSTformer(nn.Module):
    """The DSTformer of ``cfg`` (the paper code's ``DSTformer`` with
    ``dim_rep`` set and ``att_fuse``), weights from :meth:`init_weights`."""

    kind = "dstformer"

    def __init__(self, cfg: DSTformerConfig):
        super().__init__()
        self.config = cfg
        c = cfg.dim_feat
        self.joints_embed = nn.Linear(cfg.dim_in, c)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, c))
        self.temp_embed = nn.Parameter(torch.zeros(1, cfg.maxlen, 1, c))
        self.blocks_st = nn.ModuleList(Block(cfg, "stage_st") for _ in range(cfg.depth))
        self.blocks_ts = nn.ModuleList(Block(cfg, "stage_ts") for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.pre_logits = nn.Sequential()
        self.pre_logits.add_module("fc", nn.Linear(c, cfg.dim_rep))
        self.pre_logits.add_module("act", nn.Tanh())
        self.head = nn.Linear(cfg.dim_rep, cfg.dim_out)
        if cfg.att_fuse:
            self.ts_attn = nn.ModuleList(nn.Linear(2 * c, 2) for _ in range(cfg.depth))
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator=None) -> None:
        """The paper code's initialisation: linear weights and both embeddings
        truncated normal (std 0.02, cut at 2 std), biases 0, LayerNorms 1 and 0,
        each gate's weight 0 and bias 0.5."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_(m.weight, 0.02, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        trunc_normal_(self.pos_embed, 0.02, generator)
        trunc_normal_(self.temp_embed, 0.02, generator)
        if self.config.att_fuse:
            for gate in self.ts_attn:
                gate.weight.fill_(0.0)
                gate.bias.fill_(0.5)

    def forward(self, x):
        f = x.shape[1]
        if f > self.config.maxlen:
            raise ValueError(f"{f} frames are more than maxlen {self.config.maxlen}")
        h = self.joints_embed(x) + self.pos_embed + self.temp_embed[:, :f]
        for i, (st, ts) in enumerate(zip(self.blocks_st, self.blocks_ts)):
            h_st, h_ts = st(h), ts(h)
            with span("vp3d.dst.fuse"):
                if self.config.att_fuse:
                    alpha = torch.softmax(self.ts_attn[i](torch.cat([h_st, h_ts], dim=-1)),
                                          dim=-1)
                    h = h_st * alpha[..., 0:1] + h_ts * alpha[..., 1:2]
                else:
                    h = (h_st + h_ts) * 0.5
        return self.head(self.pre_logits(self.norm(h)))

    def train_forward(self, use_strided: bool):
        """The training forward the trainer calls (one form: clips of frames)."""
        return forward_train

    def per_sample_loss(self, pred, target):
        return per_sample_loss(pred, target)

    def optimizer(self, learning_rate: float) -> torch.optim.Optimizer:
        """AdamW over every parameter, the recipe's weight decay."""
        return torch.optim.AdamW(self.parameters(), lr=learning_rate,
                                 weight_decay=self.config.weight_decay)


def trunc_normal_(t, std: float, generator=None):
    """``t`` filled in place with a normal of ``std`` truncated at +-2 std, by the
    inverse CDF of one uniform draw."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=generator, device=t.device, dtype=torch.float64)
    return t.copy_(torch.special.ndtri(lo + (1.0 - 2.0 * lo) * u) * std)


def forward_train(model: DSTformer, x, *, momentum=None, generator=None, shard=None):
    """Training forward: (B, T, J, dim_in) clips -> (B, T, J, dim_out) poses.
    ``momentum`` and ``generator`` are the ConvNet's (BatchNorm, dropout) and
    unused; the DSTformer holds no batch statistics.  Counts the tokens
    (``dst.tokens``)."""
    if shard is not None:
        raise NotImplementedError("the DSTformer trains on one process")
    count("dst.tokens", x.shape[0] * x.shape[1] * x.shape[2])
    return model(x)


def per_sample_loss(pred, target):
    """(B,) per clip: MPJPE + 0.5 N-MPJPE + 20 velocity error of (B, T, J, 3)
    poses whose root joint is set to 0 (the target's already is).  N-MPJPE takes
    one scale a frame, ``<target, pred> / |pred|^2`` over the joints; the
    velocity error is the mean joint distance of the first differences along
    T."""
    pred = torch.cat([torch.zeros_like(pred[:, :, :1]), pred[:, :, 1:]], dim=2)
    dist = lambda a, b: torch.linalg.vector_norm(a - b, dim=-1).mean(dim=(1, 2))
    scale = ((target * pred).sum(-1, keepdim=True).mean(-2, keepdim=True)
             / (pred * pred).sum(-1, keepdim=True).mean(-2, keepdim=True))
    vel = dist(pred[:, 1:] - pred[:, :-1], target[:, 1:] - target[:, :-1])
    return dist(pred, target) + 0.5 * dist(scale * pred, target) + 20.0 * vel


@torch.no_grad()
def forward_clips(model: DSTformer, x):
    """Evaluation forward of videos of any length: (rows, T, J, dim_in) ->
    (rows, T, J, dim_out), the frames cut into consecutive clips of ``maxlen``,
    the last edge-padded to ``maxlen`` and its padded frames dropped; every
    row's clips in one batch."""
    was_training = model.training
    model.eval()
    try:
        rows, t = x.shape[:2]
        length = model.config.maxlen
        clips = -(-t // length)
        if clips * length > t:
            x = torch.cat([x, x[:, -1:].expand(rows, clips * length - t, *x.shape[2:])], 1)
        dtype = model.joints_embed.weight.dtype
        y = model(x.to(dtype).reshape(rows * clips, length, *x.shape[2:]))
        return y.reshape(rows, clips * length, *y.shape[2:])[:, :t]
    finally:
        model.train(was_training)
