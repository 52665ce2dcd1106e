"""Traffic kind ``semi``: semi-supervised training steps of the strided pose and
trajectory networks, as the training CLI drives them under ``-sun`` once warm-up
is over.

Set-up builds one trainer (``videopose3d_torch.train.SemiSupervisedTrainer``:
both models on the traffic's train engine, one AMSGrad optimizer over both, the
device-resident labeled and unlabeled streams, the labeled chunk sampler and the
endless unlabeled one), runs its first ``check_steps`` steps through the
window's own call and feed, keeps each step's losses, its gradient's and its
update's norm by leaf and the parameters it began from, and hands the same
trainer to the window.  The check runs the float64 reference over the same
steps, each from the parameters the program began it with: the objective parts
two runs on rounding alone within a few steps (a bone's sign, a clamp), so
steps compared free-running would measure that and not the program.  Every step of the checked, warm-up, timed and traced stretches is a
full step: the unlabeled batch is concatenated to the labeled one and all four
losses count.  A step's frames are its valid labeled and unlabeled rows, each
one output frame that both networks train on.  The window runs steps until
``--seconds`` have passed and ends with a synchronise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import program, semi_data, synth
from perfbench.drivers.train import k2_ranges
from perfbench.reference import semi as rs
from perfbench.trace import span


class Driver:
    def __init__(self, config, traffic, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)

    def _step(self):
        """One full step; returns (valid rows, the step's four losses)."""
        meta, n_valid = next(self.labeled)
        meta_u, n_valid_u = next(self.unlabeled)
        losses = self.trainer.step(self.dev_l, self.dev_u, meta, n_valid, meta_u, n_valid_u,
                                   self.momentum, False, generator=self.gen)
        return n_valid + n_valid_u, losses

    def _feed(self, sampler):
        while True:
            yield from sampler.next_epoch()

    def setup(self):
        from videopose3d_torch.data.generators import ChunkedPairSampler, FlatSequenceDataset
        from videopose3d_torch.train import (SemiSupervisedTrainer, TrainLoopConfig,
                                             bn_momentum_for_epoch, make_optimizer)
        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.stages = program.Stages()
        self.cfg_traj = semi_data.trajectory_config(cfg)
        self.w_pos = synth.make_weights(cfg, self.seed, dev)
        self.w_traj = semi_data.trajectory_weights(cfg, self.seed, dev)
        models = []
        for c, w in ((cfg, self.w_pos), (self.cfg_traj, self.w_traj)):
            m = program.model(c, dev, compute_dtype=tr["compute_dtype"], train_engine=tr["engine"])
            synth.load_into(m, w)
            m.train()
            models.append(m)
        self.stages.mark("models", dev)
        self.p2_l, self.p3_l = semi_data.labeled_set(tr, self.seed, dev)
        self.p2_u, self.cams_u = semi_data.unlabeled_set(tr, self.seed, dev)
        self.stages.mark("data")
        self.pad, self.shift = program.pad_and_shift(cfg)
        loop = TrainLoopConfig(batch_size=tr["batch_size"], chunk_length=1, pad=self.pad,
                               causal_shift=self.shift, learning_rate=tr["learning_rate"],
                               epochs=tr["epochs"], warmup=0,
                               bone_length_term=tr["bone_length_term"],
                               linear_projection=tr["linear_projection"])
        perm = synth.flip_perm(cfg["num_joints_in"])
        flips = (perm, perm) if tr["augment"] else None
        margins = FlatSequenceDataset.training_margins(self.pad, self.shift, 1)
        self.dev_l = FlatSequenceDataset(self.p2_l, self.p3_l, None, margins=margins,
                                         flip_perms=flips).to_device(dev)
        self.dev_u = FlatSequenceDataset(self.p2_u, None, self.cams_u, margins=margins,
                                         flip_perms=flips).to_device(dev)
        self.stages.mark("datasets", dev)
        self.lengths_l = [len(p) for p in self.p2_l]
        self.lengths_u = [len(p) for p in self.p2_u]
        self.seed_l, self.seed_u = synth.sub_seed(self.seed, 6, 32), synth.sub_seed(self.seed, 25, 32)
        self.labeled = self._feed(ChunkedPairSampler(
            self.lengths_l, tr["batch_size"], 1, random_seed=self.seed_l, augment=tr["augment"]))
        self.unlabeled = ChunkedPairSampler(
            self.lengths_u, tr["batch_size"], 1, random_seed=self.seed_u, augment=tr["augment"],
            endless=True).next_epoch()
        self.stages.mark("samplers")
        self.models = models
        self.optimizer = make_optimizer(models, tr["learning_rate"])
        self.trainer = SemiSupervisedTrainer(models[0], models[1], loop, self.optimizer,
                                             np.asarray(cfg["skeleton_parents"]))
        self.mask_seed = synth.sub_seed(self.seed, 7)
        self.gen = torch.Generator(device=dev).manual_seed(self.mask_seed)
        self.momentum = bn_momentum_for_epoch(loop, 0)
        self.stages.mark("trainer")

        # The checked steps: the first steps of the window's own call and feed,
        # each with the parameters it began from (on the host), its losses, and
        # its gradient's and its update's norm by leaf.
        names = {f"{prefix}.{n}": p for prefix, m in zip(("pos", "traj"), models)
                 for n, p in m.named_parameters()}
        self.checked = []
        for _ in range(tr["check_steps"]):
            before = {n: p.detach().to("cpu", copy=True) for n, p in names.items()}
            losses = rs.five_losses(*(float(v) for v in self._step()[1]))
            self.checked.append((
                losses, {n: float(p.grad.double().norm()) for n, p in names.items()},
                {n: float((p.detach().cpu().double() - before[n].double()).norm())
                 for n, p in names.items()}, before))
        self.stages.mark("checked_steps", dev)
        for _ in range(tr["warmup_steps"]):
            self._step()
        self.stages.mark("warmup", dev)

    def window(self, seconds: float):
        program.sync(self.device)
        start = time.perf_counter()
        steps = frames = 0
        while True:
            frames += self._step()[0]
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        program.sync(self.device)
        elapsed = time.perf_counter() - start
        batch = self.traffic["batch_size"]
        return {"attempted": steps, "seconds": elapsed, "steps": steps, "frames": frames,
                "batch": batch, "rows": 2 * batch, "train_frames_per_s": frames / elapsed}

    def traced(self):
        steps = self.traffic["traced_steps"]
        with k2_ranges():
            for _ in range(steps):
                with span("bench.semi.step"):
                    self._step()
        batch = self.traffic["batch_size"]
        return {"steps": steps, "batch": batch, "rows": 2 * batch}

    def free(self):
        self.models = self.optimizer = self.trainer = self.dev_l = self.dev_u = None
        self.labeled = self.unlabeled = None

    def _reference(self, dtype, tf32: bool, starts=None):
        from perfbench.reference import model as rm
        tr, cfg = self.traffic, self.cfg
        perm = synth.flip_perm(cfg["num_joints_in"])
        b, n = tr["batch_size"], tr["check_steps"]
        steps = []
        for (chunks_l, n_l), (chunks_u, n_u) in zip(
                rs.first_batches(self.lengths_l, b, n, self.seed_l, tr["augment"]),
                rs.first_batches(self.lengths_u, b, n, self.seed_u, tr["augment"])):
            x2_l, x3_l, root_l = rs.labeled_windows(self.p2_l, self.p3_l, chunks_l, self.pad,
                                                    self.shift, perm, perm)
            x2_u, target_u, cam_u = rs.unlabeled_windows(self.p2_u, self.cams_u, chunks_u,
                                                         self.pad, self.shift, perm)
            steps.append({"x2_l": x2_l, "x3_l": x3_l, "root_l": root_l, "n_l": n_l,
                          "x2_u": x2_u, "target_u": target_u, "cam_u": cam_u, "n_u": n_u})
        with rm.precision(tf32):
            return rs.semi_steps(self.w_pos, self.w_traj, cfg, self.cfg_traj, steps,
                                 cfg["skeleton_parents"], self.mask_seed, tr["learning_rate"],
                                 dtype, self.device, distortion=not tr["linear_projection"],
                                 bone_term=tr["bone_length_term"], starts=starts)

    def check(self):
        """The checked steps against the float64 reference, each step from the
        parameters the program began it with."""
        return rs.compare(self.checked, self._reference(
            torch.float64, False, starts=[c[3] for c in self.checked]))

    def control(self):
        """The same numbers with the reference at TF32 in the program's place."""
        tf32 = self._reference(torch.float32, True)
        return rs.compare(tf32, self._reference(torch.float64, False,
                                                   starts=[c[3] for c in tf32]))
