"""Custom (in-the-wild) 2D detection converter.

Same as ``videopose3d_tpu/data/prepare/custom_2d.py`` (the reference's
``data/prepare_data_2d_custom.py``):
turns per-video Detectron ``.npz`` outputs into a custom-dataset archive: pick
the best-scored bbox per frame, repair detection gaps by linear interpolation
over time (bbox and all 17 COCO keypoints), and emit one "subject" per video
plus ``video_metadata`` resolutions for the viz path.

Independent implementation: gap repair is a single vectorized
:func:`fill_time_gaps` over all coordinate columns at once, not a per-column
``np.interp`` loop.

Usage::

    python -m videopose3d_torch.data.prepare.custom_2d -i /path/to/detections \
        -o myvideos [--data-dir data]
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Optional, Tuple

import numpy as np

from videopose3d_torch.data.prepare.layouts import suggest_metadata

COCO_JOINTS = 17


def fill_time_gaps(arr: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Linearly interpolate invalid frames from their valid neighbours.

    ``arr`` is (T, ...) with arbitrary trailing dims, ``valid`` a (T,) bool
    mask; frames outside the first/last valid frame are clamped to the nearest
    valid one (``np.interp`` edge semantics).  Vectorized over every trailing
    column simultaneously.
    """
    anchors = np.flatnonzero(valid)
    if anchors.size == 0:
        raise ValueError("cannot repair a sequence with zero valid frames")
    t = np.arange(arr.shape[0])
    lo = np.clip(np.searchsorted(anchors, t, side="right") - 1,
                 0, anchors.size - 1)
    hi = np.clip(np.searchsorted(anchors, t, side="left"),
                 0, anchors.size - 1)
    span = (anchors[hi] - anchors[lo]).astype(arr.dtype)
    frac = np.where(span > 0, (t - anchors[lo]) / np.maximum(span, 1), 0.0)
    frac = frac.reshape((-1,) + (1,) * (arr.ndim - 1)).astype(arr.dtype)
    return arr[anchors[lo]] * (1 - frac) + arr[anchors[hi]] * frac


def _top_detection(frame_boxes, frame_keypoints
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Best-scored (bbox[4], keypoints[17, 4]) of one frame, or None if the
    detector produced nothing.  Detectron packs per-frame person detections as
    ``[[], array(n, 5)]`` boxes / ``[[], array(n, 4, 17)]`` keypoints."""
    people = frame_boxes[1]
    poses = frame_keypoints[1]
    if len(people) == 0 or len(poses) == 0:
        return None
    winner = int(np.argmax(people[:, 4]))
    return people[winner, :4], poses[winner].T.copy()


def decode(filename):
    """Decode one per-video Detectron archive into gap-repaired (T, 17, 2)
    keypoints + (T, 4) bboxes, reporting how many frames needed repair."""
    print(f"Processing {filename}")
    archive = np.load(filename, encoding="latin1", allow_pickle=True)
    metadata = archive["metadata"].item()
    frames = list(zip(archive["boxes"], archive["keypoints"]))

    n = len(frames)
    bboxes = np.full((n, 4), np.nan, np.float32)
    joints = np.full((n, COCO_JOINTS, 4), np.nan, np.float32)
    for i, (fb, fk) in enumerate(frames):
        hit = _top_detection(fb, fk)
        if hit is not None:
            bboxes[i], joints[i] = hit
    joints = joints[:, :, :2]

    detected = ~np.isnan(bboxes[:, 0])
    bboxes = fill_time_gaps(bboxes, detected)
    joints = fill_time_gaps(joints, detected)

    print(f"{n} total frames processed")
    print(f"{int(np.sum(~detected))} frames were interpolated")
    print("----------")
    return [{
        "start_frame": 0,
        "end_frame": n,
        "bounding_boxes": bboxes,
        "keypoints": joints,
    }], metadata


def main(argv=None):
    parser = argparse.ArgumentParser(description="Custom dataset creator")
    parser.add_argument("-i", "--input", type=str, default="", metavar="PATH",
                        help="detections directory")
    parser.add_argument("-o", "--output", type=str, default="", metavar="PATH",
                        help="output suffix for 2D detections")
    parser.add_argument("--data-dir", default="data", type=str, metavar="PATH")
    args = parser.parse_args(argv)

    if not args.input:
        parser.error("Please specify the input directory")
    if not args.output:
        parser.error("Please specify an output suffix (e.g. detectron_pt_coco)")

    print("Parsing 2D detections from", args.input)
    metadata = suggest_metadata("coco")
    metadata["video_metadata"] = {}

    subjects = {}
    for path in glob(os.path.join(args.input, "*.npz")):
        video_name = os.path.splitext(os.path.basename(path))[0]
        clips, video_meta = decode(path)
        subjects[video_name] = {
            "custom": [clip["keypoints"].astype(np.float32)
                       for clip in clips]}
        metadata["video_metadata"][video_name] = video_meta

    print("Saving...")
    os.makedirs(args.data_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(args.data_dir, f"data_2d_custom_{args.output}.npz"),
        positions_2d=subjects, metadata=metadata)
    print("Done.")


if __name__ == "__main__":
    main()
