"""What the benchmark takes from the program (``videopose3d_torch``): the model
object it serves and trains, built from a configuration of ``configs/``."""

from __future__ import annotations

import time

import torch

from perfbench import counts


def model_config(cfg, **overrides):
    from videopose3d_torch.models.temporal import TemporalModelConfig
    return TemporalModelConfig(
        num_joints_in=cfg["num_joints_in"], in_features=cfg["in_features"],
        num_joints_out=cfg["num_joints_out"], filter_widths=tuple(cfg["filter_widths"]),
        causal=cfg["causal"], dropout=cfg["dropout"], channels=cfg["channels"],
        **overrides)


def model(cfg, device, **overrides):
    """The program's model of ``cfg`` on ``device`` (weights to be loaded)."""
    from videopose3d_torch.models.temporal import TemporalModel
    return TemporalModel(model_config(cfg, **overrides)).to(device)


def pad_and_shift(cfg):
    """(pad, causal shift) of the model's input window: half the receptive field,
    all of it on the past side for a causal model."""
    pad = (counts.receptive_field(cfg) - 1) // 2
    return pad, (pad if cfg["causal"] else 0)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Stages:
    """Host seconds of each named stage of a set-up, for the run's log."""

    def __init__(self):
        self.marks = [("start", time.perf_counter())]

    def mark(self, name: str, device=None):
        if device is not None:
            sync(device)
        self.marks.append((name, time.perf_counter()))

    def __str__(self):
        return " ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(self.marks, self.marks[1:]))
