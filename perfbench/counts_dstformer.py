"""Operations and bytes of the DSTformer's training step, counted from the
configuration's shapes as ``counts.py`` counts the ConvNet's: a multiply-add is
two operations; LayerNorm, GELU, the softmaxes and the residual adds are left
out (under 2 % of the products' operations at the published widths).

``cfg`` is a configuration dict of ``configs/`` (``dim_feat``, ``dim_rep``,
``depth``, ``mlp_ratio``, ``num_joints``, ``dim_in``, ``dim_out``, ``maxlen``,
``num_heads``, ``att_fuse``)."""

from __future__ import annotations

from perfbench import counts


def _streams(cfg) -> int:
    """Attention sub-layers of each kind (spatial, temporal) in one forward: one
    per stream per layer."""
    return 2 * cfg["depth"]


def linear_macs_per_token(cfg) -> int:
    """Multiply-adds of every linear layer for one token: the embedding, four
    sub-layers a stream (qkv 3C^2 + proj C^2 twice, two MLPs of 2 r C^2), the
    gates, the representation and the head."""
    c, r = cfg["dim_feat"], cfg["mlp_ratio"]
    sub = 2 * (4 * c * c) + 2 * (2 * r * c * c)
    gate = 2 * c * 2 if cfg["att_fuse"] else 0
    return (cfg["dim_in"] * c + _streams(cfg) * sub + cfg["depth"] * gate
            + c * cfg["dim_rep"] + cfg["dim_rep"] * cfg["dim_out"])


def attention_macs_per_token(cfg, frames: int) -> int:
    """Multiply-adds of the attention cores (scores and weighted sum, every head)
    for one token of a clip of ``frames``: 2 L C a core over L keys."""
    c = cfg["dim_feat"]
    return _streams(cfg) * (2 * frames * c + 2 * cfg["num_joints"] * c)


def forward_ops(cfg, clips: int, frames: int) -> int:
    """Model operations of one forward over ``clips`` clips of ``frames``."""
    tokens = clips * frames * cfg["num_joints"]
    return 2 * tokens * (linear_macs_per_token(cfg) + attention_macs_per_token(cfg, frames))


def train_step_ops(cfg, clips: int, frames: int) -> int:
    """A training step: the forward and a backward of twice its work."""
    return 3 * forward_ops(cfg, clips, frames)


def attention_core_ops(cfg, clips: int, frames: int) -> int:
    """Operations of every attention core of one step, forward (scores, weighted
    sum) and backward (dV, dP, dQ, dK): six L C products a token a core."""
    tokens = clips * frames * cfg["num_joints"]
    return 3 * 2 * tokens * attention_macs_per_token(cfg, frames)


def attention_core_bytes(cfg, clips: int, frames: int, dtype: str = "float32") -> int:
    """Bytes of the same: each core's Q, K, V and O once, and its probabilities
    written once and read once (every head, L x L a frame or a joint)."""
    j, h, c = cfg["num_joints"], cfg["num_heads"], cfg["dim_feat"]
    tokens = clips * frames * j
    qkvo = 4 * tokens * c
    probs = 2 * clips * h * (frames * j * j + j * frames * frames)
    return counts.DTYPE_BYTES[dtype] * _streams(cfg) * (2 * qkvo + probs)
