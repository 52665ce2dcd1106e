"""Supervised training: the strided train step over the device-resident dataset.

Counterpart of the supervised half of ``videopose3d_tpu/train.py``
(``TrainLoopConfig``, ``bn_momentum_for_epoch``, ``SupervisedTrainer``): batch
assembly from ``(B, 4)`` chunk descriptors on the device, root-centring, the
strided forward with train-mode BatchNorm and dropout, the masked MPJPE loss,
its backward and an AMSGrad step (``torch.optim.Adam(amsgrad=True)``, which
the JAX package's ``scale_by_torch_amsgrad`` reproduces).  Per step only the
descriptors and the valid-row count go to the device.

The final partial batch of an epoch is padded with copies of its first row: the
loss masks them out, while the BatchNorm batch statistics include them, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from videopose3d_torch.data.generators import (FlatSequenceDataset,
                                               assemble_chunked_batch_contiguous)
from videopose3d_torch.models.temporal import TemporalModel, forward_strided


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    """Schedule hyperparameters (the JAX package's, supervised part)."""

    batch_size: int              # chunks per step (= --batch-size // --stride)
    chunk_length: int            # --stride
    pad: int
    causal_shift: int
    learning_rate: float = 1e-3
    lr_decay: float = 0.95
    epochs: int = 60
    initial_momentum: float = 0.1
    final_momentum: float = 0.001
    use_strided: bool = True
    # 2D-window copy: "auto" (the kernel on a CUDA stream, the plain version on
    # a CPU one), "pallas" (the kernel), "xla" (plain indexing).
    gather_impl: str = "auto"

    def __post_init__(self):
        if self.gather_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"gather_impl={self.gather_impl!r}: must be one of "
                             "'auto', 'xla', 'pallas'")
        if self.use_strided and self.chunk_length != 1:
            raise ValueError("use_strided=True requires chunk_length == 1 "
                             f"(got {self.chunk_length})")


def bn_momentum_for_epoch(cfg: TrainLoopConfig, epoch: int) -> float:
    """Exponential BatchNorm momentum decay 0.1 -> 0.001, evaluated at
    epoch + 1 as the reference does."""
    return cfg.initial_momentum * float(np.exp(
        -(epoch + 1) / cfg.epochs * np.log(cfg.initial_momentum / cfg.final_momentum)))


def make_optimizer(model: TemporalModel, learning_rate: float) -> torch.optim.Adam:
    """Adam with AMSGrad, the reference's optimizer; the lr is set per epoch."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, amsgrad=True)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _mpjpe_per_sample(pred, target):
    """(B,) per-sample MPJPE (mean over frames and joints)."""
    return torch.linalg.vector_norm(pred - target, dim=-1).mean(dim=(1, 2))


def _masked_sample_mean(per_sample, mask):
    """Mean over the valid samples; mask: (B,) float."""
    return (per_sample * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _check_margins(dev, loop: TrainLoopConfig) -> None:
    """Fail when the dataset's baked margins do not cover this loop's windows
    (an out-of-range window would be clamped to other frames, silently)."""
    if dev.margins is None:
        return
    need = FlatSequenceDataset.training_margins(loop.pad, loop.causal_shift,
                                                loop.chunk_length)
    if any(have < want for have, want in zip(dev.margins, need)):
        raise ValueError(
            f"dataset margins {dev.margins} do not cover the training windows {need} "
            f"required by pad={loop.pad}, causal_shift={loop.causal_shift}, "
            f"chunk_length={loop.chunk_length}; rebuild the FlatSequenceDataset with "
            "FlatSequenceDataset.training_margins(...) for this model")


class SupervisedTrainer:
    """The supervised train step of one model and optimizer.

    ``step`` returns the step's loss as a 0-d tensor on the device, not yet
    synchronised, so a loop of steps queues work without waiting for the card.
    """

    def __init__(self, model: TemporalModel, loop_cfg: TrainLoopConfig,
                 optimizer: torch.optim.Optimizer):
        if not loop_cfg.use_strided:
            raise NotImplementedError(
                "training the dilated form (--stride > 1, --dense or "
                "--disable-optimizations) is not ported to videopose3d_torch yet "
                "(see ROADMAP.md, Queue 1)")
        self.model = model
        self.loop_cfg = loop_cfg
        self.optimizer = optimizer

    def step(self, dev, meta, n_valid: int, momentum: float, generator=None):
        """One step on descriptors ``meta`` (B, 4) with ``n_valid`` real rows;
        dropout masks come from ``generator`` (None: no dropout)."""
        loop = self.loop_cfg
        _check_margins(dev, loop)
        device = dev.base_2d.device
        meta = torch.from_numpy(np.ascontiguousarray(meta, np.int32)).to(device)
        batch_3d, batch_2d = assemble_chunked_batch_contiguous(
            dev, meta, pad=loop.pad, causal_shift=loop.causal_shift,
            chunk_length=loop.chunk_length, gather_impl=loop.gather_impl)
        batch_3d = batch_3d.clone()
        batch_3d[:, :, 0] = 0.0  # root-centre: the trajectory is not learned here
        mask = (torch.arange(meta.shape[0], device=device) < n_valid).float()

        self.optimizer.zero_grad(set_to_none=True)
        pred = forward_strided(self.model, batch_2d, momentum=momentum,
                               generator=generator)
        loss = _masked_sample_mean(_mpjpe_per_sample(pred, batch_3d), mask)
        loss.backward()
        self.optimizer.step()
        return loss.detach()
