"""Traffic kind ``train``: supervised training steps of the strided model, as the
training CLI drives them.

Set-up builds one trainer (``videopose3d_torch.train.SupervisedTrainer``: model,
AMSGrad optimizer, the device-resident training set and the chunk sampler), runs
its first ``check_steps`` steps through the window's own call and feed, keeps
their losses, the first gradient as the optimizer holds it and the parameters'
change, and hands the same trainer to the window.  The window runs steps until
``--seconds`` have passed and ends with a synchronise: every step it counts has
finished on the card.
"""

from __future__ import annotations

import contextlib
import time

import torch

from perfbench import program, synth
from perfbench.trace import span


@contextlib.contextmanager
def k2_ranges():
    """Each residual block's forward and backward through the train-block kernels
    runs inside a ``K2 forward`` / ``K2 backward`` range."""
    from videopose3d_torch.ops.kernels import train_block as trb
    cls = trb.FusedTrainBlock
    saved = cls.__dict__["forward"], cls.__dict__["backward"]
    fwd, bwd = saved[0].__func__, saved[1].__func__

    def forward(ctx, *args):
        with span("K2 forward"):
            return fwd(ctx, *args)

    def backward(ctx, *args):
        with span("K2 backward"):
            return bwd(ctx, *args)

    cls.forward, cls.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield
    finally:
        cls.forward, cls.backward = saved


class Driver:
    def __init__(self, config, traffic, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)

    def _step(self):
        meta, n_valid = next(self.batches)
        self.trainer.step(self.dev, meta, n_valid, self.momentum, generator=self.gen)
        return n_valid

    def _feed(self):
        while True:
            yield from self.sampler.next_epoch()

    def setup(self):
        from videopose3d_torch.data.generators import ChunkedPairSampler, FlatSequenceDataset
        from videopose3d_torch.train import (SupervisedTrainer, TrainLoopConfig,
                                             bn_momentum_for_epoch, make_optimizer)
        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.stages = program.Stages()
        self.w0 = synth.make_weights(cfg, self.seed, dev)
        model = program.model(cfg, dev, compute_dtype=tr["compute_dtype"],
                              train_engine=tr["engine"])
        synth.load_into(model, self.w0)
        model.train()
        self.stages.mark("model", dev)
        self.p2, self.p3 = synth.training_set(tr, self.seed, dev)
        self.stages.mark("data")
        self.lengths = [len(p) for p in self.p2]
        self.pad, self.shift = program.pad_and_shift(cfg)
        loop = TrainLoopConfig(batch_size=tr["batch_size"], chunk_length=1, pad=self.pad,
                               causal_shift=self.shift, learning_rate=tr["learning_rate"],
                               epochs=tr["epochs"])
        perm = synth.flip_perm(cfg["num_joints_in"])
        margins = FlatSequenceDataset.training_margins(self.pad, self.shift, 1)
        self.dev = FlatSequenceDataset(
            self.p2, self.p3, None, margins=margins,
            flip_perms=(perm, perm) if tr["augment"] else None).to_device(dev)
        self.stages.mark("dataset", dev)
        self.sampler_seed = synth.sub_seed(self.seed, 6, 32)
        self.sampler = ChunkedPairSampler(self.lengths, tr["batch_size"], 1,
                                          random_seed=self.sampler_seed,
                                          augment=tr["augment"])
        self.batches = self._feed()
        self.stages.mark("sampler")
        self.model = model
        self.optimizer = make_optimizer(model, tr["learning_rate"])
        self.trainer = SupervisedTrainer(model, loop, self.optimizer)
        self.mask_seed = synth.sub_seed(self.seed, 7)
        self.gen = torch.Generator(device=dev).manual_seed(self.mask_seed)
        self.momentum = bn_momentum_for_epoch(loop, 0)
        self.stages.mark("trainer")

        # The checked steps: the first steps of the window's own call and feed.
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        names = dict(model.named_parameters())
        losses = []
        for k in range(tr["check_steps"]):
            meta, n_valid = next(self.batches)
            losses.append(self.trainer.step(self.dev, meta, n_valid, self.momentum,
                                            generator=self.gen))
            if k == 0:  # the first gradient, from the optimizer's first moment
                moments = {n: self.optimizer.state[p].get("exp_avg") for n, p in names.items()}
                self.grad_norms = {n: 0.0 if m is None else float(m.double().norm()) / (1 - beta1)
                                   for n, m in moments.items()}
        self.change_norms = {n: float((p.detach().double() - self.w0[n].double()).norm())
                             for n, p in names.items()}
        self.losses = [float(v) for v in losses]
        self.stages.mark("checked_steps", dev)
        for _ in range(tr["warmup_steps"]):
            self._step()
        self.stages.mark("warmup", dev)

    def window(self, seconds: float):
        program.sync(self.device)
        start = time.perf_counter()
        steps = frames = 0
        while True:
            frames += self._step()
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        program.sync(self.device)
        elapsed = time.perf_counter() - start
        return {"attempted": steps, "seconds": elapsed, "steps": steps, "frames": frames,
                "batch": self.traffic["batch_size"], "train_frames_per_s": frames / elapsed}

    def traced(self):
        steps = self.traffic["traced_steps"]
        with k2_ranges():
            for _ in range(steps):
                with span("bench.train.step"):
                    self._step()
        return {"steps": steps, "batch": self.traffic["batch_size"]}

    def free(self):
        self.model = self.optimizer = self.trainer = self.dev = self.batches = None

    def _reference(self, dtype, tf32: bool):
        from perfbench.reference import model as rm, train as rt
        tr = self.traffic
        perm = synth.flip_perm(self.cfg["num_joints_in"])
        batches = [rt.windows(self.p2, self.p3, chunks, self.pad, self.shift, perm, perm)
                   for chunks in rt.first_batches(self.lengths, tr["batch_size"],
                                                  tr["check_steps"], self.sampler_seed,
                                                  tr["augment"])]
        with rm.precision(tf32):
            return rt.train_steps(self.w0, self.cfg, batches, self.mask_seed,
                                  tr["learning_rate"], dtype, self.device)

    def _numbers(self, losses, grad_norms, change_norms, ref):
        from perfbench.reference import train as rt
        ref_losses, ref_grads, ref_params = ref
        ref_g = {k: float(g.double().norm()) for k, g in ref_grads.items()}
        ref_c = {k: float((p.double() - self.w0[k].double()).norm())
                 for k, p in ref_params.items()}
        keep = rt.kept_leaves(ref_g)
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        return {"loss1_gap": loss_gaps[0], "loss_gap": max(loss_gaps),
                "grad_gap": rt.leaf_gap(grad_norms, ref_g, keep),
                "change_gap": rt.leaf_gap(change_norms, ref_c, keep),
                "leaves_left_out": len(ref_g) - len(keep)}

    def check(self):
        """The checked steps against the float64 reference."""
        return self._numbers(self.losses, self.grad_norms, self.change_norms,
                             self._reference(torch.float64, False))

    def control(self):
        """The same numbers with the reference at TF32 in the program's place."""
        ref = self._reference(torch.float64, False)
        losses, grads, params = self._reference(torch.float32, True)
        return self._numbers(losses, {k: float(g.double().norm()) for k, g in grads.items()},
                             {k: float((p.double() - self.w0[k].double()).norm())
                              for k, p in params.items()}, ref)
