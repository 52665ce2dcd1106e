"""Training and evaluation batches.

Counterpart of ``videopose3d_tpu/data/generators.py``:

* ``FlatSequenceDataset`` concatenates every training video into one
  margin-padded flat stream (with a pre-flipped copy for augmentation) that is
  uploaded to the device once (``to_device``), the 2D keypoints as
  ``(rows, J*F)``, with the videos' camera intrinsics beside them.
* ``ChunkedPairSampler`` (host) enumerates and shuffles the reference's
  ``(seq, start, end, flip)`` chunk pairs with the same ``RandomState`` stream
  (through the native C++ core of ``native.py`` when it is available, with
  numpy's permutation otherwise: the same permutations) and
  emits one ``(B, 4)`` int32 descriptor array per step, the final partial batch
  padded with copies of its first row and a valid-row count; ``endless`` streams
  (the semi-supervised unlabeled split) run on across permutations and resume
  mid-permutation from ``stream_state``.
* ``assemble_chunked_batch_contiguous`` turns descriptors into a batch on the
  device: the 2D windows through the window-gather kernel
  (``ops/kernels/gather_rows.py``), the 3D targets and cameras by plain indexing.
  ``assemble_chunked_batch`` does the same over streams concatenated without
  margins, clamping each window to its sequence's bounds (no CLI path uses it).
* ``UnchunkedBatcher`` yields whole videos for evaluation: padded on the host
  (``next_epoch``), or as stored (``raw_epoch``) for :func:`padded_rows` to pad
  where the frames are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class FlatSequenceDataset:
    """All videos of a split as flat margin-padded arrays (host numpy).

    Args:
      poses_2d: list of (N_i, J, F) keypoint arrays.
      poses_3d: optional list of (N_i, J3, 3) arrays of the same lengths (None
        for the unlabeled split of semi-supervised training).
      cameras: optional list of (9,) intrinsic vectors, one per video.
      margins: (left_2d, right_2d, left_3d, right_3d) frames of edge replication
        baked around every video (:meth:`training_margins`), so each training
        window is one contiguous run of rows.
      flip_perms: (kps_flip_perm, joints_flip_perm): append a horizontally
        flipped copy (x negated, left/right swapped) of each padded stream, so a
        flip is an offset of ``aug_offset_*`` rows.
    """

    def __init__(self, poses_2d: Sequence[np.ndarray],
                 poses_3d: Optional[Sequence[np.ndarray]] = None,
                 cameras: Optional[Sequence[np.ndarray]] = None,
                 margins: Optional[Tuple[int, int, int, int]] = None,
                 flip_perms=None):
        assert poses_3d is None or len(poses_3d) == len(poses_2d)
        assert cameras is None or len(cameras) == len(poses_2d)
        self.cameras = (None if cameras is None
                        else np.stack(cameras, axis=0).astype(np.float32))
        self.margins = None if margins is None else tuple(int(m) for m in margins)
        self.flat_2d_padded = self.flat_3d_padded = None
        self.base_2d = self.base_3d = None
        if margins is not None:
            l2, r2, l3, r3 = self.margins
            self.flat_2d_padded, self.base_2d = _pad_concat(poses_2d, l2, r2)
            if poses_3d is not None:
                self.flat_3d_padded, self.base_3d = _pad_concat(poses_3d, l3, r3)
        self.aug_offset_2d = self.aug_offset_3d = 0
        if flip_perms is not None and self.flat_2d_padded is not None:
            kps_perm, joints_perm = flip_perms
            self.aug_offset_2d = self.flat_2d_padded.shape[0]
            self.flat_2d_padded = _with_flipped(self.flat_2d_padded, kps_perm)
            if self.flat_3d_padded is not None and joints_perm is not None:
                self.aug_offset_3d = self.flat_3d_padded.shape[0]
                self.flat_3d_padded = _with_flipped(self.flat_3d_padded, joints_perm)

    @staticmethod
    def training_margins(pad: int, causal_shift: int, chunk_length: int):
        """Margins covering every window the chunk enumeration can request:
        2D windows span [start - pad - shift, end + pad - shift) with
        start >= -(chunk-1) and end <= N + (chunk-1)."""
        c = chunk_length - 1
        return (pad + causal_shift + c, pad - causal_shift + c, c, c)

    def to_device(self, device) -> "DeviceArrays":
        """Upload the padded streams and the (V, 9) intrinsics once to ``device``,
        the 2D stream as ``(rows, J*F)`` rows (the model flattens its input
        anyway; ``assemble_chunked_batch_contiguous(joint_axis_2d=True)`` restores
        the joint axis)."""
        if self.flat_2d_padded is None:
            raise ValueError("to_device needs the margin-padded streams (margins=)")
        put = lambda a: None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)
        return DeviceArrays(
            flat_2d_padded=put(self.flat_2d_padded.reshape(
                self.flat_2d_padded.shape[0], -1)),
            flat_3d_padded=put(self.flat_3d_padded), base_2d=put(self.base_2d),
            base_3d=put(self.base_3d), aug_offset_2d=self.aug_offset_2d,
            aug_offset_3d=self.aug_offset_3d, margins=self.margins,
            cameras=put(self.cameras), kps_shape=self.flat_2d_padded.shape[1:])


def _pad_concat(seqs, left: int, right: int):
    """Edge-replicate ``left``/``right`` frames around each sequence and
    concatenate; returns the flat array and each sequence's first real row."""
    padded, bases, off = [], [], 0
    for s in seqs:
        p = np.concatenate([np.repeat(s[:1], left, axis=0), s,
                            np.repeat(s[-1:], right, axis=0)], axis=0)
        padded.append(p.astype(np.float32))
        bases.append(off + left)
        off += p.shape[0]
    return np.concatenate(padded, axis=0), np.asarray(bases, np.int32)


def _with_flipped(arr, perm):
    """``arr`` followed by its mirror: joints permuted, x negated."""
    flipped = arr[:, np.asarray(perm, np.int64)]
    flipped[..., 0] *= -1
    return np.concatenate([arr, flipped], axis=0)


class DeviceArrays:
    """The device-resident training streams of a :class:`FlatSequenceDataset`."""

    def __init__(self, flat_2d_padded, flat_3d_padded, base_2d, base_3d,
                 aug_offset_2d: int = 0, aug_offset_3d: int = 0, margins=None,
                 cameras=None, kps_shape=None):
        self.flat_2d_padded = flat_2d_padded
        self.flat_3d_padded = flat_3d_padded
        self.base_2d = base_2d
        self.base_3d = base_3d
        self.aug_offset_2d = aug_offset_2d
        self.aug_offset_3d = aug_offset_3d
        self.margins = margins
        self.cameras = cameras      # (V, 9) float32 intrinsics, or None
        self.kps_shape = kps_shape  # (J, F) of a row of the 2D stream


class ChunkedPairSampler:
    """Host-side chunk enumerator with the reference ``ChunkedGenerator``'s pairs,
    shuffle and RNG-state semantics (the JAX package's sampler, in numpy).

    The ``(seq, start_3d, end_3d, flip)`` pairs live in an ``(N, 4)`` int64 array,
    permuted by ``np.random.RandomState(random_seed)`` once per permutation:
    through the native core (``native.permute_rows``) when ``use_native`` (None:
    when it is available), with ``RandomState.permutation`` otherwise; both give
    the same permutation and leave the same RNG state.
    Yields ``(meta, n_valid)`` per step: ``meta`` is a ``(batch_size, 4)`` int32
    array whose rows past ``n_valid`` are copies of row 0 and must be masked out.  An ``endless`` sampler's ``next_epoch`` never ends:
    it draws a new permutation whenever one is used up.
    """

    def __init__(self, sequence_lengths: Sequence[int], batch_size: int,
                 chunk_length: int, *, random_seed: int = 1234,
                 augment: bool = False, endless: bool = False,
                 use_native: Optional[bool] = None):
        pairs = []
        for i, seq_len in enumerate(sequence_lengths):
            n_chunks = (seq_len + chunk_length - 1) // chunk_length
            offset = (n_chunks * chunk_length - seq_len) // 2
            bounds = np.arange(n_chunks + 1) * chunk_length - offset
            seq_col = np.full(n_chunks, i, dtype=np.int64)
            zeros = np.zeros(n_chunks, dtype=np.int64)
            pairs.append(np.stack([seq_col, bounds[:-1], bounds[1:], zeros], axis=1))
            if augment:
                pairs.append(np.stack([seq_col, bounds[:-1], bounds[1:], 1 - zeros],
                                      axis=1))
        self.pairs = (np.concatenate(pairs, axis=0) if pairs
                      else np.zeros((0, 4), dtype=np.int64))
        self.batch_size = batch_size
        self.chunk_length = chunk_length
        self.num_batches = (len(self.pairs) + batch_size - 1) // batch_size
        self.random = np.random.RandomState(random_seed)
        self.endless = endless
        self.state = None  # (next batch index, pairs) inside an endless permutation
        self._perm_rng_state = None  # the RNG just before the current permutation
        if use_native is None:
            from videopose3d_torch import native
            use_native = native.available()
        self.use_native = use_native

    def num_frames(self) -> int:
        return self.num_batches * self.batch_size

    def random_state(self):
        return self.random.get_state()

    def set_random_state(self, state):
        if isinstance(state, np.random.RandomState):
            self.random = state
        else:
            self.random.set_state(state)

    def _draw(self):
        """A new permutation, the RNG's state before it kept."""
        self._perm_rng_state = self.random.get_state()
        if self.use_native:
            from videopose3d_torch import native
            return native.permute_rows(self.random, self.pairs)
        return self.random.permutation(self.pairs)

    def stream_state(self):
        """An endless stream's position inside its permutation: ``(next batch
        index, the RNG state just before the permutation was drawn)``; None at a
        permutation boundary and for samplers that are not endless."""
        if self.state is None or self._perm_rng_state is None:
            return None
        return int(self.state[0]), self._perm_rng_state

    def set_stream_state(self, stream_state):
        """Resume an endless stream where :meth:`stream_state` left it: rewind the
        RNG, draw the same permutation again (which leaves the RNG where the
        first draw did) and go on from the saved batch index; None restarts at a
        permutation boundary."""
        if stream_state is None:
            self.state = None
            return
        start, rng_state = stream_state
        self.random.set_state(rng_state)
        self.state = (int(start), self._draw())

    def next_epoch(self):
        if self.endless and self.num_batches == 0:
            raise ValueError("no training chunks to sample: every sequence is empty")
        while True:
            start, pairs = (0, self._draw()) if self.state is None else self.state
            for b_i in range(start, self.num_batches):
                chunks = pairs[b_i * self.batch_size: (b_i + 1) * self.batch_size]
                n_valid = len(chunks)
                if n_valid < self.batch_size:
                    filler = np.broadcast_to(chunks[0], (self.batch_size - n_valid, 4))
                    chunks = np.concatenate([chunks, filler], axis=0)
                if self.endless:
                    self.state = (b_i + 1, pairs)
                yield chunks.astype(np.int32), n_valid
            self.state = None
            if not self.endless:
                return


def assemble_chunked_batch_contiguous(dev: DeviceArrays, meta, *, pad: int,
                                      causal_shift: int, chunk_length: int,
                                      gather_impl: str = "auto", with_3d: bool = True,
                                      with_cameras: bool = False,
                                      joint_axis_2d: bool = False):
    """A training batch from ``(B, 4)`` descriptors over the margin-padded
    streams: ``(cam (B, 9) | None, batch_3d (B, chunk, J3, 3) | None,
    batch_2d (B, chunk + 2*pad, J*F))``.

    The 2D window of a descriptor starts at row
    ``base_2d[seq] + start - pad - causal_shift + flip * aug_offset_2d`` and
    spans ``chunk_length + 2*pad`` rows; the 3D target window (``with_3d``)
    starts at ``base_3d[seq] + start + flip * aug_offset_3d`` and spans
    ``chunk_length``.  A flip needs the baked flipped copies (``flip_perms=``),
    which cover the keypoints and the targets; ``with_cameras`` returns each
    row's intrinsics with entries 2 (centre x) and 7 (tangential x) negated on
    the flipped rows.  ``joint_axis_2d`` returns the 2D windows as
    ``(B, chunk + 2*pad, J, F)``, the same values.

    ``gather_impl`` copies the 2D windows: "pallas" through the window-gather
    kernel (``ops/kernels/gather_rows.py``; its plain version on a CPU tensor),
    "xla" through plain indexing, "auto" the kernel on a CUDA tensor and the
    plain version on a CPU one.  The 3D targets are always plain indexing.
    """
    from videopose3d_torch.ops.kernels.gather_rows import (gather_windows,
                                                           gather_windows_plain)
    meta = torch.as_tensor(meta).to(dev.base_2d.device).long()
    seq, start, flip = meta[:, 0], meta[:, 1], meta[:, 3]
    if not dev.aug_offset_2d and bool((flip != 0).any()):
        raise ValueError("flipped chunks need the baked flipped copy "
                         "(FlatSequenceDataset(..., flip_perms=...))")
    win_2d = chunk_length + 2 * pad
    row0_2d = dev.base_2d.long()[seq] + start - pad - causal_shift + flip * dev.aug_offset_2d
    flat = dev.flat_2d_padded
    if gather_impl == "auto":
        gather_impl = "pallas" if flat.device.type == "cuda" else "xla"
    if gather_impl == "pallas":
        batch_2d = gather_windows(flat, row0_2d, window=win_2d)
    elif gather_impl == "xla":
        batch_2d = gather_windows_plain(flat, row0_2d, window=win_2d)
    else:
        raise ValueError(f"unknown gather_impl {gather_impl!r}")
    if joint_axis_2d:
        batch_2d = batch_2d.reshape(batch_2d.shape[:2] + tuple(dev.kps_shape))
    batch_3d = cam = None
    if with_3d:
        row0_3d = dev.base_3d.long()[seq] + start + flip * dev.aug_offset_3d
        idx = row0_3d[:, None] + torch.arange(chunk_length, device=row0_3d.device)
        batch_3d = dev.flat_3d_padded[idx]
    if with_cameras:
        cam = dev.cameras[seq]
        flipped = cam.clone()
        flipped[:, 2], flipped[:, 7] = -cam[:, 2], -cam[:, 7]
        cam = torch.where(flip[:, None] != 0, flipped, cam)
    return cam, batch_3d, batch_2d


def assemble_chunked_batch(flat_2d, flat_3d, cameras, seq_bounds, meta, *, pad: int,
                           causal_shift: int, chunk_length: int, kps_flip_perm,
                           joints_flip_perm, with_3d: bool = True,
                           with_cameras: bool = False):
    """A training batch from ``(B, 4)`` descriptors ``(seq, start_3d, end_3d,
    flip)`` over streams concatenated without margins: ``(cam (B, 9) | None,
    batch_3d (B, chunk, J3, 3) | None, batch_2d (B, chunk + 2*pad, J, C))`` on
    ``flat_2d``'s device.

    ``seq_bounds`` (V, 2) holds each sequence's ``[lo, hi)`` rows of the flat
    streams.  The 2D window spans ``[start_3d - pad - causal_shift, end_3d + pad
    - causal_shift)`` and the 3D one ``[start_3d, end_3d)``, each row index
    clamped into its sequence (edge replication).  A flipped row has x negated
    and its left/right columns swapped (``kps_flip_perm`` /
    ``joints_flip_perm``), and its camera entries 2 (centre x) and 7
    (tangential x) negated.
    """
    device = flat_2d.device
    meta = torch.as_tensor(meta).to(device).long()
    bounds = torch.as_tensor(seq_bounds).to(device).long()
    seq, start_3d = meta[:, 0], meta[:, 1]
    flip = (meta[:, 3] != 0)
    lo, hi = bounds[seq, 0], bounds[seq, 1]

    def window(flat, start, length):
        rel = start[:, None] + torch.arange(length, device=device)[None, :]
        rows = lo[:, None] + torch.minimum(torch.clamp(rel, min=0), (hi - lo - 1)[:, None])
        return flat[rows.reshape(-1)].reshape((meta.shape[0], length) + flat.shape[1:])

    def flipped(batch, perm):
        sign = torch.ones(batch.shape[-1], dtype=batch.dtype, device=device)
        sign[0] = -1.0
        mirrored = batch[:, :, torch.as_tensor(np.asarray(perm), device=device).long()] * sign
        return torch.where(flip[:, None, None, None], mirrored, batch)

    batch_2d = flipped(window(flat_2d, start_3d - pad - causal_shift, chunk_length + 2 * pad),
                       kps_flip_perm)
    batch_3d = (flipped(window(flat_3d, start_3d, chunk_length), joints_flip_perm)
                if with_3d else None)
    cam = None
    if with_cameras:
        cam = torch.as_tensor(cameras).to(device)[seq]
        sign = torch.ones(cam.shape[-1], dtype=cam.dtype, device=device)
        sign[2] = sign[7] = -1.0
        cam = torch.where(flip[:, None], cam * sign, cam)
    return cam, batch_3d, batch_2d


class UnchunkedBatcher:
    """Whole-sequence evaluation batches with optional test-time flip augmentation.

    Same batches as ``videopose3d_tpu.data.generators.UnchunkedBatcher`` (the
    reference's ``UnchunkedGenerator``): one full video per step; 2D input
    edge-padded by ``(pad + causal_shift, pad - causal_shift)``; with
    ``augment`` the batch has two rows [original, flipped].

    The padded 2D input is also right-padded to the next multiple of ``bucket``
    frames (replicating the last frame), so inputs come in few distinct lengths.
    A valid-frame count is returned; the extra model outputs are sliced off on
    host.
    """

    def __init__(self, cameras, poses_3d, poses_2d, *, pad: int = 0,
                 causal_shift: int = 0, augment: bool = False,
                 kps_flip_perm: Optional[np.ndarray] = None,
                 joints_flip_perm: Optional[np.ndarray] = None,
                 bucket: int = 128, bucket_pow2: bool = False):
        assert poses_3d is None or len(poses_3d) == len(poses_2d)
        assert cameras is None or len(cameras) == len(poses_2d)
        if augment and (kps_flip_perm is None or joints_flip_perm is None):
            raise ValueError(
                "test-time augmentation requires kps_flip_perm and "
                "joints_flip_perm")
        self.cameras = cameras
        self.poses_3d = poses_3d
        self.poses_2d = poses_2d
        self.pad = pad
        self.causal_shift = causal_shift
        self.augment = augment
        self.kps_flip_perm = kps_flip_perm
        self.joints_flip_perm = joints_flip_perm
        self.bucket = bucket
        # pow2 mode: lengths are powers of two times ``bucket``.
        self.bucket_pow2 = bucket_pow2

    def num_frames(self) -> int:
        return sum(p.shape[0] for p in self.poses_2d)

    def augment_enabled(self) -> bool:
        return self.augment

    def _bucket_length(self, n: int) -> int:
        """The output frames computed for a video of ``n`` frames: ``n`` rounded up
        to the next multiple of ``bucket`` (pow2 mode: ``bucket`` times a power of
        two)."""
        if self.bucket_pow2:
            t_bucket = self.bucket
            while t_bucket < n:
                t_bucket *= 2
            return t_bucket
        return -(-n // self.bucket) * self.bucket

    def raw_epoch(self):
        """Yields a :class:`RawVideo` per video, in ``next_epoch``'s order and
        skipping the same empty videos: the frames as stored, nothing padded,
        flipped or copied.  :func:`padded_rows` builds ``next_epoch``'s
        ``padded_2d`` from one, bit for bit."""
        for i, seq_2d in enumerate(self.poses_2d):
            n = seq_2d.shape[0]
            if n == 0:
                continue
            yield RawVideo(
                cam=self.cameras[i] if self.cameras is not None else None,
                poses_3d=self.poses_3d[i] if self.poses_3d is not None else None,
                poses_2d=seq_2d, n=n, t_bucket=self._bucket_length(n), pad=self.pad,
                causal_shift=self.causal_shift, kps_flip_perm=self.kps_flip_perm)

    def next_epoch(self):
        """Yields (cam, seq_3d, padded_2d, n_out_frames) per video.

        ``padded_2d``: (1 or 2, T_bucketed + 2*pad, J, C) — row 1 (if augment) is
        the flipped copy.  ``seq_3d``: (1, N, J3, 3) un-padded ground truth (or
        None).  ``n_out_frames``: N, the number of valid output frames; the model
        produces ``T_bucketed`` outputs of which the first N are real.
        """
        n_videos = len(self.poses_2d)
        for i in range(n_videos):
            seq_2d = self.poses_2d[i]
            seq_3d = self.poses_3d[i] if self.poses_3d is not None else None
            cam = self.cameras[i] if self.cameras is not None else None
            n = seq_2d.shape[0]
            if n == 0:
                # A sequence downsampled to zero frames has nothing to
                # evaluate (and cannot be edge-padded); callers' frame-
                # weighted means are unaffected by skipping it.
                continue

            t_bucket = self._bucket_length(n)
            pad_left = self.pad + self.causal_shift
            pad_right = (self.pad - self.causal_shift) + (t_bucket - n)
            batch_2d = np.pad(
                seq_2d, ((pad_left, pad_right), (0, 0), (0, 0)), "edge")[None]

            batch_3d = None if seq_3d is None else seq_3d[None]
            batch_cam = None if cam is None else np.asarray(cam)[None]
            if self.augment:
                # Fancy indexing already returns a fresh writable array.
                flipped = batch_2d[:, :, self.kps_flip_perm]
                flipped[..., 0] *= -1
                batch_2d = np.concatenate([batch_2d, flipped], axis=0)
                if batch_cam is not None:
                    # Flip the horizontal intrinsics for the mirrored row.
                    cam_flipped = batch_cam.copy()
                    cam_flipped[0, 2] *= -1
                    cam_flipped[0, 7] *= -1
                    batch_cam = np.concatenate([batch_cam, cam_flipped], axis=0)
            yield batch_cam, batch_3d, batch_2d.astype(np.float32), n


@dataclasses.dataclass
class RawVideo:
    """One video of :meth:`UnchunkedBatcher.raw_epoch`: its frames as stored and
    what :func:`padded_rows` needs to pad them as ``next_epoch`` does."""

    cam: Optional[np.ndarray]       # (9,) intrinsics, or None
    poses_3d: Optional[np.ndarray]  # (n, J3, 3) ground truth, or None
    poses_2d: np.ndarray            # (n, J, C) keypoints
    n: int                          # frames, the valid output frames
    t_bucket: int                   # output frames computed (n bucketed)
    pad: int
    causal_shift: int
    kps_flip_perm: Optional[np.ndarray]  # the mirrored row's keypoint order

    @property
    def left(self) -> int:
        """Frames repeated before the first: ``pad + causal_shift``."""
        return self.pad + self.causal_shift

    @property
    def length(self) -> int:
        """Padded input frames: ``t_bucket + 2 * pad``."""
        return self.t_bucket + 2 * self.pad


def padded_rows(frames, n, *, length: int, left: int, flip_perm=None):
    """``UnchunkedBatcher.next_epoch``'s ``padded_2d``, built from a video's raw
    frames where they are (a plain torch function; the JAX package pads in NumPy).

    ``frames`` (>= n, J, C): the first ``n`` rows are the video's, the rest is not
    read.  ``n``: an int, or a 0-d integer tensor on ``frames``' device, so that one
    CUDA-graph capture serves every length.  Returns (1, length, J, C), row ``i``
    the frame ``clamp(i - left, 0, n - 1)`` (edge padding), with ``flip_perm`` (a
    (J,) long tensor on that device) (2, length, J, C), the second row mirrored:
    keypoints permuted, x negated.  Copies and a negation only, so bit for bit the
    batcher's."""
    device = frames.device
    last = torch.as_tensor(n, device=device) - 1
    rows = torch.minimum((torch.arange(length, device=device) - left).clamp(min=0), last)
    x = frames[rows][None]
    if flip_perm is None:
        return x
    mirrored = x[:, :, flip_perm]
    mirrored[..., 0] *= -1
    return torch.cat([x, mirrored])
