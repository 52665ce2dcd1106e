"""Training: the train steps over the device-resident dataset.

Counterpart of ``videopose3d_tpu/train.py`` (``TrainLoopConfig``,
``bn_momentum_for_epoch``, ``SupervisedTrainer``, ``SemiSupervisedTrainer``):
batch assembly from ``(B, 4)`` chunk descriptors on the device, root-centring,
the forward with train-mode BatchNorm and dropout (the strided form; under
``use_strided=False`` the dilated form on chunks of ``chunk_length`` frames, as
the JAX trainers pick ``forward_dilated``), the masked losses, their backward
and an AMSGrad step (``torch.optim.Adam(amsgrad=True)``, which the JAX
package's ``scale_by_torch_amsgrad`` reproduces).  Per step only the
descriptors and the valid-row counts go to the device.  The model supplies its
training forward (``train_forward``) and its per-sample loss: MotionBERT's
DSTformer (``models/dstformer.py``, no JAX counterpart) takes the same
supervised step on clips of ``chunk_length`` frames with pad 0, every output
frame supervised, its recipe's loss and AdamW (``make_optimizer``).

The final partial batch of an epoch is padded with copies of its first row: the
loss masks them out, while the BatchNorm batch statistics include them, as in
the JAX package.

Data parallel (``dp=``, a ``parallel.DataParallel``): every rank runs the same
samplers and receives the same global descriptors, and takes its contiguous
rows of them (K1 gathers those rows from the rank's own copy of the dataset).
The BatchNorm statistics are the global batch's and the dropout masks the
global draw (the forwards' ``shard=``); each rank's loss is its rows' masked
sum over the global valid count, so the gradients, summed over the ranks in one
flat all-reduce after ``backward``, are the global batch's, even where the
final partial batch's valid rows all lie on the first ranks.  A rank's returned
losses are its shares: summed over the ranks they are the global losses.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from videopose3d_torch.data.generators import (FlatSequenceDataset,
                                               assemble_chunked_batch_contiguous)
from videopose3d_torch.models.temporal import TemporalModel
from videopose3d_torch.ops.camera import project_to_2d, project_to_2d_linear
from videopose3d_torch.ops.losses import mpjpe_per_sample
from videopose3d_torch.parallel import mesh
from videopose3d_torch.profiling import count, span


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    """Schedule and loss-composition hyperparameters (the JAX package's)."""

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
    # Semi-supervised terms: epochs of labeled-only warmup, the bone-length term,
    # the reconstruction term left out of the total (--no-proj), and the pinhole
    # projection in place of the distorting one (--linear-projection).
    warmup: int = 1
    bone_length_term: bool = True
    no_proj: bool = False
    linear_projection: bool = False
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


def make_optimizer(models: Union[TemporalModel, Sequence[TemporalModel]],
                   learning_rate: float) -> torch.optim.Optimizer:
    """Adam with AMSGrad over the parameters of one model or of several (the
    semi-supervised pose and trajectory models share one), the reference's
    optimizer; a model with a recipe of its own (the DSTformer's AdamW) gets
    that.  The lr is set per epoch."""
    if isinstance(models, torch.nn.Module):
        if hasattr(models, "optimizer"):
            return models.optimizer(learning_rate)
        models = [models]
    return torch.optim.Adam(itertools.chain.from_iterable(m.parameters() for m in models),
                            lr=learning_rate, amsgrad=True)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


_mpjpe_per_sample = mpjpe_per_sample  # the semi-supervised trainer's pose loss


def _masked_sample_mean(per_sample, mask, rows=None):
    """Mean over the valid samples; mask: (B,) float over the global batch, of
    which ``per_sample`` holds the rows ``[start, stop)`` (default all): those
    rows' share of the global mean."""
    start, stop = (0, mask.shape[0]) if rows is None else rows
    return (per_sample * mask[start:stop]).sum() / torch.clamp(mask.sum(), min=1.0)


def _trajectory_per_sample(pred_traj, root):
    """(B,) per-sample trajectory MPJPE weighted by the inverse depth of the
    true root (camera space, taken before root-centring): far subjects move
    less on screen, so their trajectory errors count less."""
    w = torch.reciprocal(root[..., 2])  # (B, T, 1)
    return (w * torch.linalg.vector_norm(pred_traj - root, dim=-1)).mean(dim=(1, 2))


def _valid(rows: int, n: int, device):
    """(rows,) float mask of the first ``n`` rows."""
    return (torch.arange(rows, device=device) < n).float()


def _rows(dp: Optional[mesh.DataParallel], total: int):
    return (0, total) if dp is None else dp.rows(total)


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


def _forward(model, loop: TrainLoopConfig):
    """The model's train-mode forward for the loop's form (the model knows its
    own: the ConvNet's strided or dilated form, the DSTformer's clips)."""
    return model.train_forward(loop.use_strided)


def _descriptors(meta, device):
    return torch.from_numpy(np.ascontiguousarray(meta, np.int32)).to(device)


class SupervisedTrainer:
    """The supervised train step of one model and optimizer, on this rank's rows
    of each global batch under ``dp``.

    ``step`` returns the step's loss (this rank's share under ``dp``) as a 0-d
    tensor on the device, not yet synchronised, so a loop of steps queues work
    without waiting for the card.
    """

    def __init__(self, model: TemporalModel, loop_cfg: TrainLoopConfig,
                 optimizer: torch.optim.Optimizer, dp: Optional[mesh.DataParallel] = None):
        self.model = model
        self.loop_cfg = loop_cfg
        self.optimizer = optimizer
        self.dp = dp

    def step(self, dev, meta, n_valid: int, momentum: float, generator=None):
        """One step on the global descriptors ``meta`` (B, 4) with ``n_valid``
        real rows; dropout masks come from ``generator`` (None: no dropout)."""
        with span("vp3d.train.step"):
            loop = self.loop_cfg
            _check_margins(dev, loop)
            device = dev.base_2d.device
            b = meta.shape[0]
            rows = _rows(self.dp, b)
            shard = None if self.dp is None else mesh.BatchShard((rows,), b, self.dp.group)
            with span("vp3d.train.upload"):
                idx = _descriptors(meta[rows[0]:rows[1]], device)
            with span("vp3d.train.assemble"):
                _, batch_3d, batch_2d = assemble_chunked_batch_contiguous(
                    dev, idx, pad=loop.pad, causal_shift=loop.causal_shift,
                    chunk_length=loop.chunk_length, gather_impl=loop.gather_impl,
                    joint_axis_2d=True)
                batch_3d = batch_3d.clone()
                batch_3d[:, :, 0] = 0.0  # root-centre: the trajectory is not learned here

            with span("vp3d.train.forward"):
                self.optimizer.zero_grad(set_to_none=True)
                pred = _forward(self.model, loop)(self.model, batch_2d, momentum=momentum,
                                                  generator=generator, shard=shard)
            with span("vp3d.train.loss"):
                loss = _masked_sample_mean(self.model.per_sample_loss(pred, batch_3d),
                                           _valid(b, n_valid, device), rows)
            with span("vp3d.train.backward"):
                loss.backward()
            if self.dp is not None:
                with span("vp3d.train.allreduce"):
                    mesh.all_reduce_gradients(self.model.parameters(), self.dp.group)
            with span("vp3d.train.optimizer"):
                self.optimizer.step()
            return loss.detach()


class SemiSupervisedTrainer:
    """The semi-supervised train step of a pose model and a trajectory model
    under one optimizer (the JAX package's ``SemiSupervisedTrainer``, the
    reference's ``run.py:319-398``):

    * the masked MPJPE of the poses on the labeled rows (per sample, the mean
      over its ``chunk_length`` frames);
    * the trajectory MPJPE on the labeled rows, weighted by the inverse depth
      of the root, which is taken before root-centring;
    * after warmup (``skip`` false), the unlabeled batch (with its cameras) is
      concatenated to the labeled one, and two terms join: the masked MPJPE of
      the projected ``pose + trajectory`` against the unlabeled keypoints of the
      chunk's frames, ``[pad, T - pad)`` of the window (left out of the total
      under ``no_proj``), and the mean absolute difference of the labeled and
      unlabeled halves' bone lengths, each averaged over the chunk's frames.

    BatchNorm statistics run over the whole concatenated batch, filler rows
    included; dropout masks come from one generator, the pose model's first.
    ``step`` returns ``(loss_pos, loss_traj, loss_recon, loss_total)`` as 0-d
    tensors on the device, not yet synchronised.  Under a profiler it marks each
    network's forward (``vp3d.train.pose``, ``vp3d.train.traj``), the
    back-projection with its MPJPE (``vp3d.train.project``) and the bone term
    (``vp3d.train.bones``), and counts the valid rows (``train.rows_labeled``,
    ``train.rows_unlabeled``) and the steps (``train.full_steps``,
    ``train.warmup_steps``).

    Under ``dp`` a rank concatenates its rows of the labeled batch and of the
    unlabeled one; the bone-length term's two means are global (an all-reduce
    of their sums) and the term, alike on every rank, enters each rank's total
    divided by the world size, so that its gradient is counted once.
    """

    def __init__(self, pos_model: TemporalModel, traj_model: TemporalModel,
                 loop_cfg: TrainLoopConfig, optimizer: torch.optim.Optimizer,
                 skeleton_parents, dp: Optional[mesh.DataParallel] = None):
        self.pos_model = pos_model
        self.traj_model = traj_model
        self.loop_cfg = loop_cfg
        self.optimizer = optimizer
        self.dp = dp
        self._parents = torch.as_tensor(np.asarray(skeleton_parents, np.int64)[1:])

    def step(self, dev, dev_semi, meta, n_valid: int, meta_semi, n_valid_semi: int,
             momentum: float, skip: bool, generator=None):
        """One step on the global labeled descriptors ``meta`` (B, 4) and, unless
        ``skip`` (warmup), the global unlabeled ``meta_semi``; dropout masks come
        from ``generator`` (None: no dropout)."""
        with span("vp3d.train.step"):
            loop = self.loop_cfg
            _check_margins(dev, loop)
            _check_margins(dev_semi, loop)
            device = dev.base_2d.device
            b = meta.shape[0]
            rows_l = _rows(self.dp, b)
            with span("vp3d.train.upload"):
                idx_l = _descriptors(meta[rows_l[0]:rows_l[1]], device)
                if not skip:
                    b_u = meta_semi.shape[0]
                    rows_u = _rows(self.dp, b_u)
                    idx_u = _descriptors(meta_semi[rows_u[0]:rows_u[1]], device)

            def assemble(d, idx, **kw):
                return assemble_chunked_batch_contiguous(
                    d, idx, pad=loop.pad, causal_shift=loop.causal_shift,
                    chunk_length=loop.chunk_length, gather_impl=loop.gather_impl,
                    joint_axis_2d=True, **kw)

            with span("vp3d.train.assemble"):
                _, batch_3d, batch_2d = assemble(dev, idx_l)
                inputs_traj = batch_3d[:, :, :1]  # the root, before root-centring
                target_3d = batch_3d.clone()
                target_3d[:, :, 0] = 0.0
                b_l = batch_3d.shape[0]
                mask_l = _valid(b, n_valid, device)
                inputs_2d = batch_2d
                segments, total_rows = (rows_l,), b
                if not skip:
                    cam_semi, _, batch_2d_semi = assemble(dev_semi, idx_u, with_3d=False,
                                                          with_cameras=True)
                    inputs_2d = torch.cat([batch_2d, batch_2d_semi])
                    mask_u = _valid(b_u, n_valid_semi, device)
                    segments, total_rows = (rows_l, (b + rows_u[0], b + rows_u[1])), b + b_u
            shard = (None if self.dp is None
                     else mesh.BatchShard(segments, total_rows, self.dp.group))

            count("train.rows_labeled", n_valid)
            count("train.warmup_steps" if skip else "train.full_steps")
            if not skip:
                count("train.rows_unlabeled", n_valid_semi)

            with span("vp3d.train.forward"):
                self.optimizer.zero_grad(set_to_none=True)
                forward = _forward(self.pos_model, loop)
                with span("vp3d.train.pose"):
                    pred_pos = forward(self.pos_model, inputs_2d, momentum=momentum,
                                       generator=generator, shard=shard)
                with span("vp3d.train.traj"):
                    pred_traj = forward(self.traj_model, inputs_2d, momentum=momentum,
                                        generator=generator, shard=shard)
            with span("vp3d.train.loss"):
                loss_pos = _masked_sample_mean(_mpjpe_per_sample(pred_pos[:b_l], target_3d),
                                               mask_l, rows_l)
                loss_traj = _masked_sample_mean(
                    _trajectory_per_sample(pred_traj[:b_l], inputs_traj), mask_l, rows_l)
                total = loss_pos + loss_traj
                loss_recon = torch.zeros((), device=device)
                if not skip:
                    with span("vp3d.train.project"):
                        t = batch_2d_semi.shape[1]
                        target_semi = batch_2d_semi[:, loop.pad:t - loop.pad, :, :2]
                        project = (project_to_2d_linear if loop.linear_projection
                                   else project_to_2d)
                        reconstruction = project(pred_pos[b_l:] + pred_traj[b_l:], cam_semi)
                        loss_recon = _masked_sample_mean(
                            _mpjpe_per_sample(reconstruction, target_semi), mask_u, rows_u)
                    if not loop.no_proj:
                        total = total + loss_recon
                    if loop.bone_length_term:
                        with span("vp3d.train.bones"):
                            total = total + self._bone_term(pred_pos, b_l, mask_l, rows_l,
                                                            mask_u, rows_u, device)
            with span("vp3d.train.backward"):
                total.backward()
            if self.dp is not None:
                with span("vp3d.train.allreduce"):
                    mesh.all_reduce_gradients(itertools.chain(self.pos_model.parameters(),
                                                              self.traj_model.parameters()),
                                              self.dp.group)
            with span("vp3d.train.optimizer"):
                self.optimizer.step()
            return (loss_pos.detach(), loss_traj.detach(), loss_recon.detach(),
                    total.detach())

    def _bone_term(self, pred_pos, b_l, mask_l, rows_l, mask_u, rows_u, device):
        """The mean absolute difference of the labeled and unlabeled halves'
        mean bone lengths; under ``dp`` the means are global and the term is
        divided by the world size."""
        if self._parents.device != device:
            self._parents = self._parents.to(device)
        dists = pred_pos[:, :, 1:] - pred_pos[:, :, self._parents]
        bones = torch.linalg.vector_norm(dists, dim=-1).mean(dim=1)  # (B, J-1)
        sums = torch.stack([
            (bones[:b_l] * mask_l[rows_l[0]:rows_l[1], None]).sum(0),
            (bones[b_l:] * mask_u[rows_u[0]:rows_u[1], None]).sum(0)])
        if self.dp is not None:
            sums = mesh.all_reduce_sum(sums, self.dp.group)
        mean_l = sums[0] / torch.clamp(mask_l.sum(), min=1.0)
        mean_u = sums[1] / torch.clamp(mask_u.sum(), min=1.0)
        bone_term = torch.mean(torch.abs(mean_l - mean_u))
        if self.dp is not None:
            bone_term = bone_term / self.dp.world_size
        return bone_term
