"""Operations and bytes of the semi-supervised step, counted from the shapes as
``counts.py`` counts the supervised one: the pose and the trajectory network's
strided training work, each on every row of the concatenated batch (labeled
and unlabeled, filler rows included: the card computes them).  The objective's
elementwise work (projection, bone lengths, masked means) is left out: it is
under 0.01 % of the networks'."""

from __future__ import annotations

from perfbench import counts, semi_data


def networks(cfg):
    """The configurations of the pose and the trajectory network."""
    return [cfg, semi_data.trajectory_config(cfg)]


def semi_step_ops(cfg, rows: int) -> int:
    """Model operations of one step of both networks over ``rows`` rows."""
    return sum(counts.train_step_ops(c, rows) for c in networks(cfg))


def semi_block_ops(cfg, rows: int) -> int:
    """Both networks' residual blocks, forward and backward, over ``rows``."""
    return sum(counts.train_block_ops(c, rows) for c in networks(cfg))


def semi_block_bytes(cfg, rows: int, dtype: str = "float32") -> int:
    return sum(counts.train_block_bytes(c, rows, dtype) for c in networks(cfg))
