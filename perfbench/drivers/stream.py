"""Traffic kind ``stream``: live cameras served by the causal model, one pose per
stream per frame, in a closed loop.

Every dispatch hands one host frame of each of ``streams`` streams to
``StreamingCausalLifter.step`` and copies the poses back to host memory before the
next dispatch.  A dispatch's latency runs from the call of ``step`` to its poses
in host memory.  The poses of a sample of streams drawn from the seed are kept
for every dispatch of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import program, synth
from perfbench.trace import span


class Driver:
    def __init__(self, config, traffic, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)

    def setup(self):
        from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
        from videopose3d_torch.streaming import StreamingCausalLifter
        cfg, tr, dev = self.cfg, self.traffic, self.device
        self.stages = program.Stages()
        self.w = synth.make_weights(cfg, self.seed, dev)
        model = program.model(cfg, dev)
        synth.load_into(model, self.w)
        model.eval()
        self.stages.mark("model", dev)
        self.tracks = synth.stream_tracks(tr, self.seed, dev)
        self.stages.mark("data")
        self.calib = torch.as_tensor(synth.calibration_clips(self.tracks, tr), device=dev)
        q = quantize_temporal_model(model.config, model, self.calib)
        self.lifter = StreamingCausalLifter(model.config, engine=tr["engine"], quantized=q,
                                            frames_per_step=1, device=dev)
        self.stages.mark("quantize", dev)
        self.lifter.reset(self.tracks[0])
        for t in range(tr["warmup_dispatches"]):
            self.lifter.step(self.tracks[t % len(self.tracks)]).cpu()
        self.lifter.reset(self.tracks[0])
        self.stages.mark("warmup", dev)
        rng = np.random.default_rng(synth.sub_seed(self.seed, 9))
        self.sample = np.sort(rng.choice(tr["streams"], tr["checked_streams"], replace=False))
        self.t = 0

    def window(self, seconds: float):
        length, b = len(self.tracks), self.traffic["streams"]
        lat, kept = [], []
        enqueue = 0.0
        program.sync(self.device)
        start = end = time.perf_counter()
        while end - start < seconds:
            t0 = time.perf_counter()
            out = self.lifter.step(self.tracks[self.t % length])
            t1 = time.perf_counter()
            host = out.cpu().numpy()
            end = time.perf_counter()
            kept.append(host[self.sample])
            lat.append(end - t0)
            enqueue += t1 - t0
            self.t += 1
        elapsed = end - start
        self.kept = np.stack(kept)  # (dispatches, checked streams, J, 3)
        n = len(lat)
        return {"attempted": n, "seconds": elapsed, "poses": n * b,
                "stream_poses_per_s": n * b / elapsed,
                "stream_latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "enqueue_ms": enqueue / n * 1e3}

    def traced(self):
        length, n = len(self.tracks), self.traffic["traced_dispatches"]
        for _ in range(n):
            with span("bench.stream.step"):
                out = self.lifter.step(self.tracks[self.t % length])
            with span("bench.stream.d2h"):
                out.cpu()
            self.t += 1
        return {"dispatches": n, "streams": self.traffic["streams"]}

    def free(self):
        self.lifter = None

    # -- the check ---------------------------------------------------------

    def _reference(self, qmax: float, dispatches: int):
        """(dispatches, checked streams, J, 3) poses of the offline integer causal
        model over each checked stream's frames, its first frame repeated before
        it for the receptive field, quantized anew from the weights and the
        calibration clips."""
        from perfbench.reference import int8 as ri, model as rm
        qm = ri.quantize(self.w, self.cfg, self.calib, qmax=qmax)
        rf = rm.receptive_field(self.cfg)
        frames = self.tracks[:, self.sample][np.arange(dispatches) % len(self.tracks)]
        frames = np.concatenate([np.repeat(frames[:1], rf - 1, axis=0), frames])
        out = []
        for s in range(0, len(self.sample), 4):
            x = torch.as_tensor(frames[:, s:s + 4].transpose(1, 0, 2, 3), device=self.device)
            out.append(ri.forward(qm, self.cfg, x).cpu())
        return torch.cat(out).permute(1, 0, 2, 3).double()

    def check(self):
        """The kept poses of every dispatch against the int8 reference."""
        ref = self._reference(127.0, len(self.kept))
        gap = (torch.as_tensor(self.kept).double() - ref).abs().max() / ref.abs().max()
        return {"pose_gap": float(gap)}

    def control(self, dispatches: int):
        """``pose_gap`` with the reference at int4 in the program's place."""
        ref = self._reference(127.0, dispatches)
        low = self._reference(7.0, dispatches)
        return {"pose_gap": float((low - ref).abs().max() / ref.abs().max())}
