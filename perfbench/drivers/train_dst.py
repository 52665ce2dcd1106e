"""Traffic kind ``train_dst``: supervised training steps of MotionBERT's DSTformer
on clips of ``maxlen`` frames, as the training CLI's ``--model dstformer`` drives
them.

Set-up builds one trainer (``videopose3d_torch.train.SupervisedTrainer``: the
DSTformer, its AdamW, the device-resident training set of (x, y, confidence)
keypoints and the clip sampler), runs its first ``check_steps`` steps through the
window's own call and feed, keeps their losses, the first gradient as AdamW's
first moment holds it and the parameters' change, and hands the same trainer to
the window.  Every step runs in float32 with TF32 off (``full_float32``), as the
CLI's training loop does.  The window runs steps until ``--seconds`` have passed
and ends with a synchronise.  A step's frames are its valid clips times
``maxlen``: every output frame is supervised.

The check runs the float64 reference (``reference/dstformer.py``) over the same
clips from the same weights, its gradients summed over groups of
``check_group`` clips (LayerNorm holds no statistics across clips), so it fits
beside nothing else on the card once the program's state is freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import program, synth
from perfbench.reference import dstformer as rd, train as rt
from perfbench.trace import span


def model_config(cfg):
    from videopose3d_torch.models.dstformer import DSTformerConfig
    keys = ("num_joints", "dim_in", "dim_out", "dim_feat", "dim_rep", "depth", "num_heads",
            "mlp_ratio", "maxlen", "qkv_bias", "att_fuse", "ln_eps")
    return DSTformerConfig(**{k: cfg[k] for k in keys},
                           weight_decay=cfg["recipe"]["weight_decay"])


def make_weights(cfg, seed: int, device):
    """float32 weights as published (``assumed``): linear weights and embeddings
    truncated normal (std 0.02, at 2 std) from one uniform draw through the
    inverse normal CDF, biases 0, LayerNorms 1 and 0, gates 0 and 0.5."""
    shapes = rd.param_shapes(cfg)
    drawn = [(n, s) for n, s, kind in shapes if kind in ("weight", "embed")]
    sizes = [int(np.prod(s)) for _, s in drawn]
    u = torch.rand(sum(sizes), generator=synth.generator(seed, 41, device), device=device,
                   dtype=torch.float64)
    lo = 0.5 * (1.0 + float(torch.erf(torch.tensor(-2.0 / np.sqrt(2.0), dtype=torch.float64))))
    normal = (torch.special.ndtri(lo + (1.0 - 2.0 * lo) * u) * 0.02).float()
    out, start = {}, 0
    for (name, shape), n in zip(drawn, sizes):
        out[name] = normal[start:start + n].reshape(shape)
        start += n
    fill = {"bias": 0.0, "ln_bias": 0.0, "ln_weight": 1.0, "gate_weight": 0.0, "gate_bias": 0.5}
    for name, shape, kind in shapes:
        if kind in fill:
            out[name] = torch.full(shape, fill[kind], device=device)
    return out


def with_confidence(poses_2d, seed: int, device):
    """Each track's keypoints with a third feature, a confidence uniform in
    [0.5, 1] from the seed."""
    lengths = [len(p) for p in poses_2d]
    conf = (torch.rand(sum(lengths), poses_2d[0].shape[1], 1, generator=synth.generator(
        seed, 40, device), device=device) * 0.5 + 0.5).cpu().numpy()
    return [np.concatenate([p, c], axis=-1)
            for p, c in zip(poses_2d, np.split(conf, np.cumsum(lengths)[:-1]))]


class Driver:
    def __init__(self, config, traffic, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)

    def _step(self):
        from videopose3d_torch.evaluate import full_float32
        meta, n_valid = next(self.batches)
        with full_float32():
            loss = self.trainer.step(self.dev, meta, n_valid, 0.0)
        return n_valid, loss

    def _feed(self):
        while True:
            yield from self.sampler.next_epoch()

    def setup(self):
        from videopose3d_torch.models.dstformer import DSTformer
        from videopose3d_torch.data.generators import ChunkedPairSampler, FlatSequenceDataset
        from videopose3d_torch.train import SupervisedTrainer, TrainLoopConfig, make_optimizer
        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.stages = program.Stages()
        self.w0 = make_weights(cfg, self.seed, dev)
        model = DSTformer(model_config(cfg)).to(dev)
        synth.load_into(model, self.w0)
        model.train()
        self.stages.mark("model", dev)
        p2, self.p3 = synth.training_set(tr, self.seed, dev)
        self.p2 = with_confidence(p2, self.seed, dev)
        self.stages.mark("data")
        self.lengths = [len(p) for p in self.p2]
        clip = cfg["maxlen"]
        loop = TrainLoopConfig(batch_size=tr["batch_size"], chunk_length=clip, pad=0,
                               causal_shift=0, learning_rate=tr["learning_rate"],
                               lr_decay=cfg["recipe"]["lr_decay"], epochs=tr["epochs"],
                               use_strided=False)
        perm = synth.flip_perm(cfg["num_joints"])
        margins = FlatSequenceDataset.training_margins(0, 0, clip)
        self.dev = FlatSequenceDataset(
            self.p2, self.p3, None, margins=margins,
            flip_perms=(perm, perm) if tr["augment"] else None).to_device(dev)
        self.stages.mark("dataset", dev)
        self.sampler_seed = synth.sub_seed(self.seed, 6, 32)
        self.sampler = ChunkedPairSampler(self.lengths, tr["batch_size"], clip,
                                          random_seed=self.sampler_seed,
                                          augment=tr["augment"])
        self.batches = self._feed()
        self.stages.mark("sampler")
        self.model = model
        self.optimizer = make_optimizer(model, tr["learning_rate"])
        self.trainer = SupervisedTrainer(model, loop, self.optimizer)
        self.stages.mark("trainer")

        # The checked steps: the first steps of the window's own call and feed.
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        names = dict(model.named_parameters())
        losses = []
        for k in range(tr["check_steps"]):
            losses.append(self._step()[1])
            if k == 0:  # the first gradient, from AdamW's first moment
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
        steps = clips = 0
        while True:
            clips += self._step()[0]
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        program.sync(self.device)
        elapsed = time.perf_counter() - start
        frames = clips * self.cfg["maxlen"]
        return {"attempted": steps, "seconds": elapsed, "steps": steps, "frames": frames,
                "batch": self.traffic["batch_size"], "train_frames_per_s": frames / elapsed}

    def traced(self):
        steps = self.traffic["traced_steps"]
        for _ in range(steps):
            with span("bench.train_dst.step"):
                self._step()
        return {"steps": steps, "batch": self.traffic["batch_size"]}

    def free(self):
        self.model = self.optimizer = self.trainer = self.dev = self.batches = None

    def _reference(self, dtype, tf32: bool):
        tr, cfg = self.traffic, self.cfg
        perm = synth.flip_perm(cfg["num_joints"])
        batches = [rd.windows(self.p2, self.p3, chunks, perm, perm)
                   for chunks in rd.first_batches(self.lengths, tr["batch_size"],
                                                  tr["check_steps"], cfg["maxlen"],
                                                  self.sampler_seed, tr["augment"])]
        return rd.train_steps(self.w0, cfg, batches, tr["learning_rate"],
                              cfg["recipe"]["weight_decay"], dtype, self.device,
                              group=tr["check_group"], tf32=tf32)

    def _numbers(self, losses, grad_norms, change_norms, ref):
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
