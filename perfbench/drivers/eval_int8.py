"""Traffic kind ``eval_int8``: the ``eval`` traffic (whole videos, TTA, the four
protocols, one action at a time) on the w8a8 int8 engine (``--serving-engine
int8``: the K4 stage kernels in slice mode on the raw videos).

The float model is built in float32 whatever ``compute_dtype`` says (``int8``, the
dtype whose peak ``eval.mfu`` reads). The int8 scales are calibrated once, in the
set-up, through ``Evaluator.set_calibration`` on the first ``calibration_frames``
frames of ``calibration_videos`` test videos spread evenly over the set (as the
streaming CLI calibrates on its streams); the warm-up is then made again, one
video of each padded length, so that the quantization and whatever the engine
prepares a length (a CUDA graph, where it captures one) fall outside the window.
The check holds the kept poses against ``reference/int8.py``'s ``quantize`` and
``forward`` on the same calibration; the control puts its int4 (w4a4) form in the
program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.drivers import eval as base


class Driver(base.Driver):
    def setup(self):
        from videopose3d_torch.data.generators import UnchunkedBatcher
        from videopose3d_torch.evaluate import evaluate
        tr = self.traffic
        self.traffic = {**tr, "compute_dtype": "float32"}  # the float model's dtype
        try:
            super().setup()
        finally:
            self.traffic = tr
        videos = [v for action in self.actions for v in action]
        n, t = tr["calibration_videos"], tr["calibration_frames"]
        picked = [i * (len(videos) - 1) // max(n - 1, 1) for i in range(n)]
        self.calib = np.stack([videos[i][0][:t] for i in picked])
        self.evaluator.set_calibration(self.calib)
        by_length = {}
        for v in videos:
            by_length.setdefault(self._t_in(len(v[0])), v)
        warm = list(by_length.values())
        evaluate(self.evaluator, self.model, UnchunkedBatcher(
            None, [v[1] for v in warm], [v[0] for v in warm], pad=self.pad,
            causal_shift=self.shift, augment=tr["augment"], kps_flip_perm=self.perm,
            joints_flip_perm=self.perm, bucket=tr["bucket"]), verbose=False)
        self.stages.mark("quantize", self.device)
        self._quantized = {}

    def _poses(self, x, precision: str):
        """Reference poses of one video: "float64" names the integer model the cell
        is held to (int8, ``qmax`` 127), "int4" the control's (``qmax`` 7), both
        quantized from the float weights on the cell's calibration clips."""
        from perfbench.reference import int8 as ri
        qmax = {"float64": 127.0, "int4": 7.0}[precision]
        qm = self._quantized.get(qmax)
        if qm is None:
            calib = torch.as_tensor(self.calib, device=self.device)
            qm = self._quantized[qmax] = ri.quantize(self.w, self.cfg, calib, qmax=qmax)
        return self._merge(ri.forward(qm, self.cfg, x)).double()
