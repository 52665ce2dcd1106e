"""Evaluation: whole-sequence inference with test-time augmentation and the four
protocols (MPJPE / P-MPJPE / N-MPJPE / MPJVE).

Counterpart of ``videopose3d_tpu/evaluate.py`` (``Evaluator``, ``evaluate``,
``evaluate_actionwise``, ``DeviceEvalSet``); the printed protocol lines have the
same format.  Inference and the TTA merge run on the evaluator's device, or
round-robin over several local ``devices`` (a copy of the model on each).  On
CUDA devices each video's raw frames and 3D poses go up in one copy from reused
pinned memory, the edge padding and the mirrored row are made there, the
``fused`` and ``int8`` engines replay one CUDA graph per padded length, and the four
protocols run there too, one kernel a video (``ops/kernels/protocols.py``), and
one fetch a call brings their means back; on the CPU the batcher pads on the
host and the protocols run on host numpy, as in the JAX package.  The per-epoch
training losses run on the device.  A DSTformer (``models/dstformer.py``)
evaluates on the ``xla`` engine, each video (pad 0) cut into consecutive clips of
``maxlen`` frames, the last edge-padded and its padded frames dropped
(``forward_clips``); the TTA merge and the protocols are the ConvNet's.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from videopose3d_torch.data.generators import RawVideo, padded_rows
from videopose3d_torch.models.dstformer import DSTformerConfig, forward_clips
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                forward_dilated, forward_dilated_fused,
                                                _fused_operands, forward_dilated_int8,
                                                tensor_state)
from videopose3d_torch.ops.kernels.build import count_replay, recorded_launches
from videopose3d_torch.ops.kernels.protocols import video_protocols
from videopose3d_torch.ops.kernels.temporal_block_int8 import (quantize_temporal_model,
                                                                quantized_on)
from videopose3d_torch.ops.losses import (mean_velocity_error, mpjpe_np, n_mpjpe_np,
                                          p_mpjpe)
from videopose3d_torch.parallel import mesh
from videopose3d_torch.profiling import count, span


@contextlib.contextmanager
def full_float32():
    """float32 matmuls and convolutions without TF32, restored afterwards.

    cuDNN convolutions default to TF32 on the card (about three decimal
    digits); metric-grade evaluation needs true float32, as the JAX package's
    ``default_matmul_precision("highest")``."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _device_of(model: TemporalModel) -> torch.device:
    return next(model.parameters()).device


def _upload(array, device) -> torch.Tensor:
    """``array`` as a float32 tensor on ``device``; to a card through pinned memory
    and without waiting for the card (a pageable copy waits for its stream)."""
    x = torch.as_tensor(np.asarray(array, np.float32))
    if torch.device(device).type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


# float32 words of a staged video before its frames: n as an int32, then padding to
# 16 bytes.  The frames follow, (n, J, C), and right after them the 3D poses.
_HEADER = 4


def _staged_words(video: RawVideo) -> int:
    """Float32 words of ``video``'s staged form: the header, its frames and its 3D
    poses (if any)."""
    poses = 0 if video.poses_3d is None else video.poses_3d.size
    return _HEADER + video.poses_2d.size + poses


def _stage(words: np.ndarray, video: RawVideo) -> None:
    """Writes ``video``'s staged form into the leading words of the float32 array
    ``words``: one copy of the frames and one of the poses, on this thread."""
    words[:1].view(np.int32)[0] = video.n
    end = _HEADER + video.poses_2d.size
    np.copyto(words[_HEADER:end].reshape(video.poses_2d.shape), video.poses_2d)
    if video.poses_3d is not None:
        np.copyto(words[end:end + video.poses_3d.size].reshape(video.poses_3d.shape),
                  video.poses_3d)


def _staged_frames(buf, rows: int, frame_shape):
    """n (a 0-d int32 tensor) and ``rows`` frames of a video staged in ``buf``;
    frames past the n-th hold other data and are never read."""
    words = int(np.prod(frame_shape))
    frames = buf[_HEADER:_HEADER + rows * words].view((rows,) + tuple(frame_shape))
    return buf[:1].view(torch.int32)[0], frames


def _staged_poses(buf, video: RawVideo):
    """The 3D poses of ``video`` staged in ``buf``, or None."""
    if video.poses_3d is None:
        return None
    start = _HEADER + video.poses_2d.size
    return buf[start:start + video.poses_3d.size].view(video.poses_3d.shape)


class _Staging:
    """Pinned host buffers for one card's uploads, used in turn: a buffer is
    overwritten only after the event recorded behind its last upload has passed, so
    the host may run a few videos ahead of the card."""

    SLOTS = 4

    def __init__(self, device: torch.device):
        self.device = device
        self._slots = [None] * self.SLOTS  # (pinned tensor, its NumPy view, event)
        self._turn = 0

    def upload(self, video: RawVideo, dst: torch.Tensor) -> None:
        """``video``'s staged form into the leading words of ``dst`` on the card: one
        host copy into a pinned buffer, one copy to the card that does not block."""
        i, self._turn = self._turn, (self._turn + 1) % self.SLOTS
        slot = self._slots[i]
        if slot is not None:
            slot[2].synchronize()  # its last upload has read it
        need = _staged_words(video)
        if slot is None or slot[0].numel() < need:
            pinned = torch.empty(1 << (need - 1).bit_length(), pin_memory=True)
            slot = (pinned, pinned.numpy(), torch.cuda.Event())
            self._slots[i] = slot
        _stage(slot[1], video)
        dst[:need].copy_(slot[0][:need], non_blocking=True)
        slot[2].record(torch.cuda.current_stream(self.device))


class _GraphSet:
    """One device's video graphs, all captured at one state of the model's tensors.
    They allocate from one memory pool, on one capture stream (the allocator reuses
    a block only on its stream): each reads only its own input buffer, kept alive
    with it, and writes its intermediates before reading them, so the graphs replay
    safely in any order."""

    def __init__(self, state, device: torch.device):
        self.state, self.device = state, device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        # (rows, padded length, dtype, J, C, pad, shift, mirror order) -> graph
        self.graphs = {}
        self.warm = False  # whether a video ran eagerly on the device at this state


class _VideoGraph:
    """The ``fused`` or ``int8`` evaluation of one padded length on a card as one
    CUDA graph: the edge padding and the mirrored row (:func:`padded_rows`, n read
    from the staged header), the forward through ``Evaluator.infer`` and the TTA merge,
    captured over a fixed input buffer at the first replay and replayed for every
    video of that length.  The same kernels on the same inputs as the eager path,
    so the poses are its bit for bit."""

    def __init__(self, evaluator: "Evaluator", model: TemporalModel, video: RawVideo,
                 augment: bool, graphs: _GraphSet):
        self.evaluator, self.model, self.augment, self.set = evaluator, model, augment, graphs
        self.rows, self.frame_shape = video.t_bucket, video.poses_2d.shape[1:]
        self.length, self.left = video.length, video.left
        poses = evaluator.model_cfg.num_joints_out * 3
        self.buf = torch.zeros(_HEADER + self.rows * (video.poses_2d[0].size + poses),
                               device=graphs.device)
        self.perm = (torch.as_tensor(np.asarray(video.kps_flip_perm), dtype=torch.long,
                                     device=graphs.device) if augment else None)
        self.graph = None

    def _body(self):
        n, frames = _staged_frames(self.buf, self.rows, self.frame_shape)
        x = padded_rows(frames, n, length=self.length, left=self.left, flip_perm=self.perm)
        return self.evaluator._tta_merge(self.evaluator.infer(self.model, x), self.augment)

    @torch.no_grad()
    def _capture(self) -> None:
        if not self.set.warm:
            # The first video on a device at a model state runs eagerly: it loads the
            # kernels and makes the device's copies (the joints' flip order), which a
            # capture cannot.  None of it depends on the padded length, so the later
            # lengths are captured directly.
            self._body()
            self.set.warm = True
        # The graph reads operands of the model it does not hold (the fused forward's,
        # or the quantized model): made here, outside the capture, and held with it,
        # so that no later evaluation (of another dtype, say) frees what its replays
        # read.
        self.operands = self.evaluator._graph_operands(self.model, self.set.device)
        current = torch.cuda.current_stream(self.set.device)
        self.set.stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        # A capture runs nothing: its launches are recorded, and counted once a replay.
        with torch.cuda.stream(self.set.stream), recorded_launches() as self.launches:
            graph.capture_begin(pool=self.set.pool, capture_error_mode="thread_local")
            try:
                self.out = self._body()
            finally:
                graph.capture_end()
        current.wait_stream(self.set.stream)
        self.graph = graph
        count("eval.graph_captures")

    def replay(self) -> None:
        """Runs the graph on the video staged in ``buf``, into ``out``."""
        if self.graph is None:
            self._capture()
        self.graph.replay()
        count("eval.graph_replays")
        count_replay(self.launches)


class Evaluator:
    """Whole-sequence inference on one device.

    Engines:
      * ``"xla"`` (default) — metric grade: the plain torch model in float32
        with TF32 off, whatever the configured compute dtype (a DSTformer's
        config takes this engine only, on clips of ``maxlen`` frames).
      * ``"fused"`` — the fused CUDA block kernels at the model's compute dtype.
      * ``"int8"`` — the w8a8 int8 stage kernels, for bulk serving (mm-level
        accuracy, not metric grade).  The model is quantized on the first
        predicted batch, or on :meth:`set_calibration` data, and requantized
        whenever a parameter or buffer of the model is replaced or written in
        place (``load_state_dict``, an optimizer step).

    A batch on another device than the model's runs on a copy of the model there
    (of the quantized model for ``int8``, quantized once on the model's device),
    made once per model state.

    On a card, ``fused`` and ``int8`` evaluate each :class:`RawVideo` by one
    CUDA-graph replay, one graph per device, padded length and mirroring, captured
    at the first video of each and again after the model's tensors change or the
    quantization is reset (the first video on a device at a model state also runs
    once eagerly, before its capture: it quantizes an ``int8`` model on its input
    when no calibration was set); ``xla`` runs eagerly (cuDNN picks its own
    algorithms).
    """

    def __init__(self, model_cfg: TemporalModelConfig,
                 joints_flip_perm: Optional[np.ndarray] = None,
                 engine: str = "xla", device: torch.device = torch.device("cuda")):
        if engine not in ("xla", "fused", "int8"):
            raise ValueError(f"unknown engine {engine!r}")
        if isinstance(model_cfg, DSTformerConfig) and engine != "xla":
            raise ValueError(f"the DSTformer evaluates on the xla engine only, not {engine!r}")
        if engine == "xla" and model_cfg.compute_dtype != "float32":
            model_cfg = dataclasses.replace(model_cfg, compute_dtype="float32")
        self.engine = engine
        self.model_cfg = model_cfg
        self.device = torch.device(device)
        self.joints_flip_perm = (None if joints_flip_perm is None else
                                 torch.as_tensor(np.asarray(joints_flip_perm),
                                                 dtype=torch.long, device=self.device))
        self._calibration = None
        self._q_resets = 0  # resets of the quantization: the int8 graphs' state
        self._copies = {}  # (what, device) -> (key, the copy on that device)
        self._staging = {}  # device -> _Staging
        self._graph_sets = {}  # device -> _GraphSet
        # The 3D poses uploaded with the last raw video, on the card (None without):
        # a view of the buffer they went up in, valid until the next upload into it,
        # on the graph path the next video of the same padded length on that device.
        # Kernels enqueued on the device's current stream before then read them.
        self.target = None
        self.reset_quantization()

    def reset_quantization(self):
        """Drop the quantized model; the next int8 inference quantizes anew (and
        captures the int8 video graphs again)."""
        self._q = None
        self._q_key = None
        self._q_tensors = None
        self._q_resets += 1

    def set_calibration(self, batch_2d) -> None:
        """Calibrate the int8 scales on this (B, T, J, C) batch, or on a list of
        batches (ragged B and T) flattened to one time axis so the ranges cover
        several clips, instead of on the first predicted batch."""
        if isinstance(batch_2d, (list, tuple)):
            flat = [np.asarray(b, np.float32).reshape((1, -1) + np.asarray(b).shape[-2:])
                    for b in batch_2d]
            batch_2d = np.concatenate(flat, axis=1)
        self._calibration = torch.as_tensor(np.asarray(batch_2d, np.float32))
        self.reset_quantization()

    def quantized(self, model: TemporalModel, x):
        """The cached int8 model of ``model``, (re)quantized on the calibration
        data or on ``x`` when the model's tensors changed.  The key is every
        parameter's and buffer's identity and version counter (in-place writes
        bump it); the tensors are held so that their ids stay unique."""
        tensors = list(itertools.chain(model.parameters(), model.buffers()))
        key = tuple((id(t), t._version) for t in tensors)
        if self._q is None or self._q_key != key:
            calib = x if self._calibration is None else self._calibration
            self._q = quantize_temporal_model(self.model_cfg, model,
                                              calib.to(_device_of(model)))
            self._q_key, self._q_tensors = key, tensors
        return self._q

    def _on(self, what: str, source, key, device, move):
        """``move(source, device)``, made once per ``key`` and device."""
        hit = self._copies.get((what, device))
        if hit is None or hit[0] != key:
            hit = (key, move(source, device))
            self._copies[(what, device)] = hit
        return hit[1]

    def _model_on(self, model: TemporalModel, device):
        """``model``, or its copy on ``device`` (remade when its tensors change)."""
        if device == _device_of(model):
            return model
        key = tuple((id(t), t._version)
                    for t in itertools.chain(model.parameters(), model.buffers()))
        return self._on("model", model, key, device,
                        lambda m, d: copy.deepcopy(m).to(d).eval())

    def _tta_merge(self, pred, augment: bool):
        if not augment:
            return pred
        # Undo the flip of row 1 and average with row 0.
        flipped = pred[1].clone()
        flipped[..., 0] *= -1.0
        if self.joints_flip_perm is not None:
            perm = self._on("perm", self.joints_flip_perm, None, flipped.device,
                            lambda t, d: t.to(d))
            flipped = flipped[:, perm]
        return ((pred[0] + flipped) * 0.5)[None]

    @torch.no_grad()
    def infer(self, model: TemporalModel, x):
        """(rows, T_in, J, C) keypoints on a device -> (rows, T_out, J_out, 3)
        there."""
        if self.engine == "int8":
            q = self.quantized(model, x)
            if x.device != _device_of(model):
                q = self._on("int8", q, self._q_key, x.device, quantized_on)
            return forward_dilated_int8(self.model_cfg, q, x)
        model = self._model_on(model, x.device)
        if self.engine == "fused":
            return forward_dilated_fused(self.model_cfg, model, x)
        with full_float32():
            if isinstance(self.model_cfg, DSTformerConfig):
                return forward_clips(model, x)
            return forward_dilated(model, x)

    def predict_async(self, model: TemporalModel, batch_2d, augment: bool, device=None):
        """(rows, T_in, J, C) padded keypoints, or on a card a :class:`RawVideo` of
        ``UnchunkedBatcher.raw_epoch`` -> (1, T_out, J_out, 3) poses as a tensor of
        their own on ``device`` (default the evaluator's), not yet synchronised.

        A raw video goes up with its 3D poses, which are left in ``self.target``
        for the protocols, and is padded on the card."""
        device = self.device if device is None else torch.device(device)
        with span("vp3d.eval.predict"):
            if isinstance(batch_2d, RawVideo):
                return self._predict_video(model, batch_2d, augment, device)
            with span("vp3d.eval.upload"):
                x = _upload(batch_2d, device)
            with span("vp3d.eval.infer"):
                pred = self.infer(model, x)
            with span("vp3d.eval.merge"):
                return self._tta_merge(pred, augment)

    def _graph(self, model: TemporalModel, video: RawVideo, augment: bool, device):
        """The graph of ``video``'s padded length on ``device``; a model state (or a
        reset of the quantization) the device's graphs were not captured at drops
        them all.  ``int8`` graphs infer on the model itself: the quantized model
        is copied to ``device`` (``infer``)."""
        if self.engine == "fused":
            model = self._model_on(model, device)
        state = (tensor_state(model), self._q_resets)
        graphs = self._graph_sets.get(device)
        if graphs is None or graphs.state != state:
            graphs = self._graph_sets[device] = _GraphSet(state, device)
        perm = np.asarray(video.kps_flip_perm).tobytes() if augment else None
        key = (2 if augment else 1, video.t_bucket, self.model_cfg.matmul_dtype,
               video.poses_2d.shape[1:], video.pad, video.causal_shift, perm)
        graph = graphs.graphs.get(key)
        if graph is None:
            graph = graphs.graphs[key] = _VideoGraph(self, model, video, augment, graphs)
        return graph

    def _graph_operands(self, model: TemporalModel, device):
        """What a video graph on ``device`` reads of ``model`` and does not hold: the
        fused forward's operands, or the quantized model there (quantized by the
        eager run before the first capture)."""
        if self.engine == "int8":
            if device == _device_of(model):
                return self._q
            return self._on("int8", self._q, self._q_key, device, quantized_on)
        return _fused_operands(model, self.model_cfg.matmul_dtype)

    def _predict_video(self, model: TemporalModel, video: RawVideo, augment: bool, device):
        """``predict_async`` of a raw video: staged and uploaded, padded on the
        card; one graph replay for ``fused`` and ``int8``, else eagerly."""
        if device.type != "cuda":
            raise ValueError(f"a raw video is evaluated on a card, not on {device}: "
                             "the batcher pads it on the host (next_epoch)")
        if device.index is None:
            # As a tensor's device: a model there is on it, not on a copy.
            device = torch.device("cuda", torch.cuda.current_device())
        graph = (self._graph(model, video, augment, device)
                 if self.engine in ("fused", "int8") else None)
        with span("vp3d.eval.upload"):
            buf = (graph.buf if graph is not None
                   else torch.empty(_staged_words(video), device=device))
            staging = self._staging.get(device)
            if staging is None:
                staging = self._staging[device] = _Staging(device)
            staging.upload(video, buf)
            self.target = _staged_poses(buf, video)
            if graph is None:
                n, frames = _staged_frames(buf, video.n, video.poses_2d.shape[1:])
                perm = None
                if augment:
                    flip = np.asarray(video.kps_flip_perm)
                    perm = self._on("kps_perm", flip, flip.tobytes(), device,
                                    lambda a, d: torch.as_tensor(a, dtype=torch.long,
                                                                 device=d))
                x = padded_rows(frames, n, length=video.length, left=video.left,
                                flip_perm=perm)
        if graph is not None:
            with span("vp3d.eval.infer"):
                graph.replay()
            with span("vp3d.eval.merge"):
                return graph.out.clone()
        with span("vp3d.eval.infer"):
            pred = self.infer(model, x)
        with span("vp3d.eval.merge"):
            return self._tta_merge(pred, augment)


class DeviceEvalSet:
    """Per-epoch evaluation set resident on the device (the JAX package's
    ``DeviceEvalSet``).

    Every video's padded 2D input and its zero-padded, root-zeroed 3D target are
    uploaded once; with ``with_traj`` also its trajectory target (the root, before
    root-zeroing) and its camera's intrinsics, for the semi-supervised losses.
    Each epoch runs inference and the masked losses per video on the device,
    accumulates the frame-weighted sums there, and brings only those to the host.
    No test-time augmentation.

    ``shard=(rank, world_size)``: this rank keeps every world_size-th video from
    its rank on, and :meth:`losses` all-reduces the ranks' sums and frame counts
    over the default process group, so every rank returns the whole set's losses.
    ``devices``: local devices the kept videos go round-robin over (default
    ``[device]``); the per-video sums are added on ``device`` in video order, so
    the result does not depend on the device count.
    """

    def __init__(self, batcher, *, pad: int, device, with_traj: bool = False,
                 shard=None, devices=None):
        self.device = torch.device(device)
        self.devices = [torch.device(d) for d in devices] if devices else [self.device]
        self.pad = pad
        self.shard = shard
        self._videos = []
        self.n_frames = 0
        for seq_i, (cam, batch_3d, batch_2d, n) in enumerate(batcher.next_epoch()):
            if shard is not None and seq_i % shard[1] != shard[0]:
                continue
            on = self.devices[len(self._videos) % len(self.devices)]
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(on)
            t_out = batch_2d.shape[1] - 2 * pad
            video = {"batch_2d": put(batch_2d[:1]), "n": n}
            if batch_3d is not None:
                target = np.zeros((1, t_out) + batch_3d.shape[2:], np.float32)
                target[0, :n] = batch_3d[0]
                if with_traj:
                    video["traj_target"] = put(target[:, :, :1])
                target[:, :, 0] = 0.0
                video["target"] = put(target)
            if with_traj and cam is not None:
                video["cam"] = put(np.asarray(cam)[:1])
            self._videos.append(video)
            self.n_frames += n

    @staticmethod
    def _masked_mpjpe(pred, target, n: int):
        """MPJPE over the first ``n`` frames of (1, T, J, D) poses."""
        dist = torch.linalg.vector_norm(pred - target, dim=-1)  # (1, T, J)
        valid = (torch.arange(dist.shape[1], device=dist.device) < n)[None, :, None]
        return torch.where(valid, dist, 0.0).sum() / max(n * dist.shape[2], 1)

    @torch.no_grad()
    def losses(self, evaluator: Evaluator, model: TemporalModel,
               traj_evaluator: Optional[Evaluator] = None,
               traj_model: Optional[TemporalModel] = None):
        """One epoch of frame-weighted losses: ``(loss_3d, loss_traj, loss_2d,
        n_frames)``, the MPJPE of the poses, of the trajectory and of the 2D
        reconstruction ``project_to_2d(pose + trajectory)`` against the input
        keypoints (the last two with a trajectory model, each where its target
        is there); zeros for an empty set.  A sharded set's ranks must all
        call it: they exchange their sums."""
        from videopose3d_torch.ops.camera import project_to_2d
        with span("vp3d.eval.losses"):
            total = torch.zeros(3, dtype=torch.float32, device=self.device)
            zeros = {}  # device -> a 0-d zero there
            for video in self._videos:
                batch_2d, n = video["batch_2d"], video["n"]
                zero = zeros.get(batch_2d.device)
                if zero is None:
                    zero = zeros[batch_2d.device] = torch.zeros((), device=batch_2d.device)
                pred = evaluator.infer(model, batch_2d)
                l3d = (self._masked_mpjpe(pred, video["target"], n) if "target" in video
                       else zero)
                ltraj = lrecon = zero
                if traj_model is not None and ("traj_target" in video or "cam" in video):
                    pred_traj = traj_evaluator.infer(traj_model, batch_2d)
                    if "traj_target" in video:
                        ltraj = self._masked_mpjpe(pred_traj, video["traj_target"], n)
                    if "cam" in video:
                        t_out = pred.shape[1]
                        target_2d = batch_2d[:, self.pad:self.pad + t_out, :, :2]
                        recon = project_to_2d(pred + pred_traj, video["cam"])
                        lrecon = self._masked_mpjpe(recon, target_2d, n)
                total = total + (n * torch.stack([l3d, ltraj, lrecon])).to(self.device)
            n_frames = self.n_frames
            if self.shard is not None:
                sums = mesh.all_reduce_(torch.cat([total.double(), torch.tensor(
                    [float(n_frames)], dtype=torch.float64, device=self.device)]))
                total, n_frames = sums[:3], int(sums[3].item())
            if n_frames == 0:
                return 0.0, 0.0, 0.0, 0
            total = total.double().cpu().numpy() / n_frames
            return float(total[0]), float(total[1]), float(total[2]), n_frames

    def loss(self, evaluator: Evaluator, model: TemporalModel) -> float:
        """Frame-weighted MPJPE over the set (metres), 0.0 for an empty set."""
        return self.losses(evaluator, model)[0]


def evaluate(evaluator: Evaluator, model: TemporalModel, batcher, *,
             action: Optional[str] = None, return_predictions: bool = False,
             verbose: bool = True, devices=None) -> Tuple[float, float, float, float]:
    """Run the four protocols over a batcher of whole videos.

    Errors are frame-weighted means, reported in mm.  With
    ``return_predictions`` the first video's (T, J, 3) camera-space prediction
    (test-time augmentation merged) is returned instead, for rendering.
    ``devices``: local devices to round-robin the videos over (default the
    evaluator's).  On CUDA devices the batcher's raw videos
    (``UnchunkedBatcher.raw_epoch``) go to ``predict_async``, each video's
    protocols run where its poses are, one kernel call a video on the 3D poses
    uploaded with its frames, and the videos' means come back in one fetch at the
    end; otherwise the batcher pads on the host (``next_epoch``) and a bounded
    queue of videos is in flight before the first fetch, so device work overlaps
    the protocols on the host.  The frame-weighted sums are taken on the host in
    the videos' order, so the numbers do not depend on the device count.
    """
    devs = [torch.device(d) for d in devices] if devices else [evaluator.device]
    on_card = all(d.type == "cuda" for d in devs)
    in_flight = max(16, 8 * len(devs))
    pending = []    # on the host: videos in flight
    on_device = []  # on the card: (frames, the video's four means there)
    errors = []     # (frames, (MPJPE, P-MPJPE, N-MPJPE, MPJVE)) a video, in order

    def consume(item):
        batch_3d, n_frames, pred = item
        with span("vp3d.eval.fetch"):
            pred = pred.cpu().numpy()[:, :n_frames]
        with span("vp3d.eval.protocols"):
            target = np.asarray(batch_3d[:1], np.float32).copy()
            target[:, :, 0] = 0.0
            with span("vp3d.eval.mpjpe"):
                e1 = mpjpe_np(pred, target)
            with span("vp3d.eval.n_mpjpe"):
                e3 = n_mpjpe_np(pred, target)

            pred_flat = pred.reshape(-1, pred.shape[-2], pred.shape[-1])
            target_flat = target.reshape(-1, target.shape[-2], target.shape[-1])
            with span("vp3d.eval.p_mpjpe"):
                e2 = float(p_mpjpe(pred_flat, target_flat))
            with span("vp3d.eval.mpjve"):
                ev = float(mean_velocity_error(pred_flat, target_flat))
        errors.append((target.shape[0] * target.shape[1], (e1, e2, e3, ev)))

    if on_card:  # raw videos, padded on the card, their 3D poses uploaded with them
        videos = ((None, video, video.n) for video in batcher.raw_epoch())
    else:
        videos = ((b3, b2, n) for _, b3, b2, n in batcher.next_epoch())
    for seq_i, (batch_3d, batch_2d, n_frames) in enumerate(videos):
        pred = evaluator.predict_async(model, batch_2d, augment=batcher.augment_enabled(),
                                       device=devs[seq_i % len(devs)])
        if return_predictions:
            return pred.cpu().numpy()[0, :n_frames]
        count("eval.frames", n_frames)
        count("eval.frames_computed", pred.shape[1])  # bucket padding included
        if on_card:
            with span("vp3d.eval.protocols"):
                on_device.append((n_frames, video_protocols(
                    pred[0].contiguous(), evaluator.target, n_frames)))
            count("eval.protocols_on_device")
            continue
        pending.append((batch_3d, n_frames, pred))
        if len(pending) >= in_flight:
            consume(pending.pop(0))
    while pending:
        consume(pending.pop(0))
    if on_device:
        home = evaluator.device if evaluator.device.type == "cuda" else devs[0]
        with span("vp3d.eval.fetch"):
            means = torch.stack([m.to(home) for _, m in on_device]).cpu().numpy()
        errors = [(n, tuple(float(e) for e in row)) for (n, _), row in zip(on_device, means)]

    epoch_loss_3d_pos = 0.0
    epoch_loss_3d_pos_procrustes = 0.0
    epoch_loss_3d_pos_scale = 0.0
    epoch_loss_3d_vel = 0.0
    n_total = 0
    for n, (e1, e2, e3, ev) in errors:
        epoch_loss_3d_pos += n * e1
        epoch_loss_3d_pos_scale += n * e3
        epoch_loss_3d_pos_procrustes += n * e2
        epoch_loss_3d_vel += n * ev
        n_total += n

    if n_total == 0:
        raise ValueError(
            "no frames to evaluate (every sequence was empty after downsampling)")
    e1 = epoch_loss_3d_pos / n_total * 1000
    e2 = epoch_loss_3d_pos_procrustes / n_total * 1000
    e3 = epoch_loss_3d_pos_scale / n_total * 1000
    ev = epoch_loss_3d_vel / n_total * 1000

    if verbose:
        print("----------" if action is None else "----" + action + "----")
        print("Test time augmentation:", batcher.augment_enabled())
        print("Protocol #1 Error (MPJPE):", e1, "mm")
        print("Protocol #2 Error (P-MPJPE):", e2, "mm")
        print("Protocol #3 Error (N-MPJPE):", e3, "mm")
        print("Velocity Error (MPJVE):", ev, "mm")
        print("----------")
    return e1, e2, e3, ev


def evaluate_actionwise(evaluator: Evaluator, model: TemporalModel,
                        all_actions: Dict, make_batcher, *, action_filter=None,
                        verbose=True, devices=None):
    """Action-wise evaluation + averages.

    Args:
      all_actions: {action_name: [(subject, action), ...]}.
      make_batcher: callable mapping a list of (subject, action) pairs to an
        UnchunkedBatcher.
      devices: local devices to round-robin each action's videos over
        (:func:`evaluate`).
    """
    errors_p1, errors_p2, errors_p3, errors_vel = [], [], [], []
    for action_key in all_actions.keys():
        if action_filter is not None:
            if not any(action_key.startswith(a) for a in action_filter):
                continue
        batcher = make_batcher(all_actions[action_key])
        e1, e2, e3, ev = evaluate(evaluator, model, batcher, action=action_key,
                                  verbose=verbose, devices=devices)
        errors_p1.append(e1)
        errors_p2.append(e2)
        errors_p3.append(e3)
        errors_vel.append(ev)

    if verbose:
        print("Protocol #1   (MPJPE) action-wise average:",
              round(float(np.mean(errors_p1)), 1), "mm")
        print("Protocol #2 (P-MPJPE) action-wise average:",
              round(float(np.mean(errors_p2)), 1), "mm")
        print("Protocol #3 (N-MPJPE) action-wise average:",
              round(float(np.mean(errors_p3)), 1), "mm")
        print("Velocity      (MPJVE) action-wise average:",
              round(float(np.mean(errors_vel)), 2), "mm")
    return (float(np.mean(errors_p1)), float(np.mean(errors_p2)),
            float(np.mean(errors_p3)), float(np.mean(errors_vel)))
