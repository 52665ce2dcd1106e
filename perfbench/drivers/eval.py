"""Traffic kind ``eval``: whole-video evaluation with test-time augmentation and
the four protocols, one action's videos at a time, as the evaluation CLI's
``evaluate_actionwise`` drives ``evaluate.evaluate``.

The window passes over the test set's actions in order, again and again, and ends
at the first action boundary after ``--seconds``.  Each video's frames count once.
The poses that ``Evaluator.predict_async`` gives for the actions of a sample drawn
from the seed (the first action, the one holding the longest video and two more of
the first pass) are kept with the protocol numbers ``evaluate`` returned for them.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import counts, program, synth
from perfbench.trace import span

PROTOCOL_FUNCTIONS = ("mpjpe_np", "n_mpjpe_np", "p_mpjpe", "mean_velocity_error")


class Driver:
    def __init__(self, config, traffic, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self._capture = None

    def _t_in(self, n: int):
        """Input frames of a video of ``n`` frames as the batcher pads it."""
        bucket = self.traffic["bucket"]
        return -(-n // bucket) * bucket + 2 * self.pad

    def setup(self):
        from videopose3d_torch.data.generators import UnchunkedBatcher
        from videopose3d_torch.evaluate import Evaluator, evaluate
        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.stages = program.Stages()
        self.w = synth.make_weights(cfg, self.seed, dev)
        self.model = program.model(cfg, dev, compute_dtype=tr["compute_dtype"])
        synth.load_into(self.model, self.w)
        self.model.eval()
        self.pad, self.shift = program.pad_and_shift(cfg)
        self.stages.mark("model", dev)
        self.actions = synth.eval_set(tr, self.seed, dev)
        self.stages.mark("data")
        self.perm = synth.flip_perm(cfg["num_joints_in"])
        self.evaluator = Evaluator(self.model.config, joints_flip_perm=self.perm,
                                   engine=tr["engine"], device=dev)
        predict = self.evaluator.predict_async

        def recorded(model, batch_2d, augment, device=None):
            with span("bench.eval.predict"):
                pred = predict(model, batch_2d, augment, device)
            if self._capture is not None:
                self._capture.append(pred)
            return pred

        self.evaluator.predict_async = recorded

        def batcher(videos):
            return UnchunkedBatcher(None, [v[1] for v in videos], [v[0] for v in videos],
                                    pad=self.pad, causal_shift=self.shift,
                                    augment=tr["augment"], kps_flip_perm=self.perm,
                                    joints_flip_perm=self.perm, bucket=tr["bucket"])

        self.batchers = [batcher(videos) for videos in self.actions]
        rows = 2 if tr["augment"] else 1
        self.frames = [sum(len(v[0]) for v in videos) for videos in self.actions]
        self.ops = [sum(counts.dilated_forward_ops(cfg, rows, self._t_in(len(v[0])))
                        for v in videos) for videos in self.actions]
        # Warm-up: one video of each padded length the set has.
        by_length = {}
        for videos in self.actions:
            for v in videos:
                by_length.setdefault(self._t_in(len(v[0])), v)
        evaluate(self.evaluator, self.model, batcher(list(by_length.values())), verbose=False)
        self.stages.mark("warmup", dev)
        # The checked actions: the first, the one with the longest video, two more.
        longest = int(np.argmax([max(len(v[0]) for v in videos) for videos in self.actions]))
        rng = np.random.default_rng(synth.sub_seed(self.seed, 8))
        picked = rng.choice(len(self.actions), size=min(2, len(self.actions)), replace=False)
        self.sample = {0, longest, *(int(a) for a in picked)}
        self.captured = {}
        self.next_action = 0

    def _evaluate(self, a: int, capture: bool):
        from videopose3d_torch.evaluate import evaluate
        self._capture = [] if capture else None
        with span("bench.eval.action"):
            numbers = evaluate(self.evaluator, self.model, self.batchers[a],
                               action=str(a), verbose=False)
        if capture:
            self.captured[a] = (self._capture, numbers)
        self._capture = None

    def window(self, seconds: float):
        program.sync(self.device)
        start = time.perf_counter()
        done = frames = videos = ops = 0
        n = len(self.actions)
        while True:
            a = done % n
            self._evaluate(a, done < n and a in self.sample)
            frames += self.frames[a]
            ops += self.ops[a]
            videos += len(self.actions[a])
            done += 1
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        self.next_action = done % n
        return {"attempted": videos, "seconds": elapsed, "frames": frames, "ops": ops,
                "actions": done, "eval_frames_per_s": frames / elapsed}

    @contextlib.contextmanager
    def _protocol_spans(self):
        from videopose3d_torch import evaluate as ev
        saved = {name: getattr(ev, name) for name in PROTOCOL_FUNCTIONS}

        def spanned(fn):
            def run(*args, **kwargs):
                with span("bench.eval.protocols"):
                    return fn(*args, **kwargs)
            return run

        for name, fn in saved.items():
            setattr(ev, name, spanned(fn))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(ev, name, fn)

    def traced(self):
        """The next ``traced_actions`` actions under the profiler."""
        calls, frames = [], 0
        n = len(self.actions)
        rows = 2 if self.traffic["augment"] else 1
        with self._protocol_spans():
            for k in range(self.traffic["traced_actions"]):
                a = (self.next_action + k) % n
                self._evaluate(a, False)
                calls += [(rows, self._t_in(len(v[0]))) for v in self.actions[a]]
                frames += self.frames[a]
        return {"calls": calls, "frames": frames}

    def free(self):
        self.model = self.evaluator = None

    # -- the check ---------------------------------------------------------

    def _tta_input(self, p2):
        """The reference's own padded input: edge frames repeated ``pad`` times on
        each side, and (with augmentation) the mirrored copy as a second row."""
        x = np.pad(p2, ((self.pad + self.shift, self.pad - self.shift), (0, 0), (0, 0)),
                   "edge")[None]
        if self.traffic["augment"]:
            flipped = x[:, :, self.perm].copy()
            flipped[..., 0] *= -1
            x = np.concatenate([x, flipped])
        return torch.as_tensor(x, device=self.device)

    def _merge(self, out):
        if not self.traffic["augment"]:
            return out[0]
        flipped = out[1].clone()
        flipped[..., 0] *= -1
        return (out[0] + flipped[:, self.perm]) / 2

    def _poses(self, x, precision: str):
        """Reference poses of one video at ``precision``: "float64"; "tf32"
        (float32 products on the TF32 tensor cores); "fp8" (every product's
        operands in float8 e4m3, one scale a tensor, float32 sums)."""
        from perfbench.reference import model as rm
        dtype = torch.float64 if precision == "float64" else torch.float32
        operand = rm.fp8 if precision == "fp8" else None
        with rm.precision(precision == "tf32"):
            return self._merge(rm.dilated_forward(self.w, self.cfg, x, dtype,
                                                  operand)).double()

    def _numbers(self, poses_of):
        """(pose_gap, protocol_gap) of the checked videos, whose poses under test
        ``poses_of(a, i, x)`` gives."""
        from perfbench.reference import protocols
        pose_gap = protocol_gap = 0.0
        for a, (_, numbers) in sorted(self.captured.items()):
            pairs = []
            for i, (p2, p3) in enumerate(self.actions[a]):
                x = self._tta_input(p2)
                ref = self._poses(x, "float64")
                got = poses_of(a, i, x)[:len(p2)]
                pose_gap = max(pose_gap, float((got - ref).abs().max() / ref.abs().max()))
                pairs.append((got.cpu().numpy(), p3))
            if numbers is not None:
                want = protocols.protocols(pairs)
                protocol_gap = max(protocol_gap, float(np.max(
                    np.abs(np.asarray(numbers) - want) / np.abs(want))))
        return {"pose_gap": pose_gap, "protocol_gap": protocol_gap}

    def check(self):
        """The kept poses against the float64 reference; the protocol numbers
        against the reference's protocols of those same poses."""
        preds = {a: preds for a, (preds, _) in self.captured.items()}
        return self._numbers(lambda a, i, x: preds[a][i][0].double())

    def control(self):
        """``pose_gap`` with the reference in the program's place at the next
        precision down (``control_precision``), over the same sample."""
        self.captured = {a: (None, None) for a in sorted(self.sample)}
        prec = self.traffic["control_precision"]
        return {"pose_gap": self._numbers(lambda a, i, x: self._poses(x, prec))["pose_gap"]}
