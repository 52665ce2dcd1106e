"""HumanEva-I dataset converter.

Same as ``videopose3d_tpu/data/prepare/humaneva.py`` (the reference's
``data/prepare_data_humaneva.py``):
converts the MATLAB-exported HumanEva streams (see ``matlab/ConvertHumanEva.m``)
into 3D/2D-GT archives, splitting corrupted (NaN) mocap streams into contiguous
``... chunkN`` actions, marking invalid chunks ``Unlabeled/``, and aligning
user-supplied 2D detections using the published per-camera sync offsets.

The train/validate frame index and sync offsets below are public HumanEva-I
dataset facts.

Usage::

    python -m videopose3d_torch.data.prepare.humaneva -p /path/to/converted \
        --convert-3d [--convert-2d /path/to/detections -o detectron_pt_coco]
"""

from __future__ import annotations

import argparse
import os
import re
from glob import glob

import numpy as np

from videopose3d_torch.data.prepare.layouts import (
    suggest_metadata, suggest_pose_importer)

SUBJECTS = ["Train/S1", "Train/S2", "Train/S3",
            "Validate/S1", "Validate/S2", "Validate/S3"]
CAM_MAP = {"C1": 0, "C2": 1, "C3": 2}

# Train/test split frame ranges [start, end) per subject/action.
INDEX = {
    "Train/S1": {"Walking 1": (590, 1203), "Jog 1": (367, 740),
                 "ThrowCatch 1": (473, 945), "Gestures 1": (395, 801),
                 "Box 1": (385, 789)},
    "Train/S2": {"Walking 1": (438, 876), "Jog 1": (398, 795),
                 "ThrowCatch 1": (550, 1128), "Gestures 1": (500, 901),
                 "Box 1": (382, 734)},
    "Train/S3": {"Walking 1": (448, 939), "Jog 1": (401, 842),
                 "ThrowCatch 1": (493, 1027), "Gestures 1": (533, 1102),
                 "Box 1": (512, 1021)},
    "Validate/S1": {"Walking 1": (5, 590), "Jog 1": (5, 367),
                    "ThrowCatch 1": (5, 473), "Gestures 1": (5, 395),
                    "Box 1": (5, 385)},
    "Validate/S2": {"Walking 1": (5, 438), "Jog 1": (5, 398),
                    "ThrowCatch 1": (5, 550), "Gestures 1": (5, 500),
                    "Box 1": (5, 382)},
    "Validate/S3": {"Walking 1": (5, 448), "Jog 1": (5, 401),
                    "ThrowCatch 1": (5, 493), "Gestures 1": (5, 533),
                    "Box 1": (5, 512)},
}

# Per-video frames to skip for camera synchronization.
SYNC_DATA = {
    "S1": {"Walking 1": (82, 81, 82), "Jog 1": (51, 51, 50),
           "ThrowCatch 1": (61, 61, 60), "Gestures 1": (45, 45, 44),
           "Box 1": (57, 57, 56)},
    "S2": {"Walking 1": (115, 115, 114), "Jog 1": (100, 100, 99),
           "ThrowCatch 1": (127, 127, 127), "Gestures 1": (122, 122, 121),
           "Box 1": (119, 119, 117)},
    "S3": {"Walking 1": (80, 80, 80), "Jog 1": (65, 65, 65),
           "ThrowCatch 1": (79, 79, 79), "Gestures 1": (83, 83, 82),
           "Box 1": (1, 1, 1)},
    "S4": {},
}


def _finite_spans(stream):
    """Partition a frame stream into maximal contiguous runs of all-finite
    vs corrupted frames.

    Returns ``[(start, stop, finite), ...]`` half-open spans covering
    ``[0, len(stream))``, computed with one vectorized finiteness reduction
    (no per-frame Python loop).
    """
    per_frame_ok = np.isfinite(stream).all(
        axis=tuple(range(1, stream.ndim)))
    flips = np.flatnonzero(per_frame_ok[1:] != per_frame_ok[:-1]) + 1
    bounds = [0, *flips.tolist(), len(per_frame_ok)]
    return [(a, b, bool(per_frame_ok[a]))
            for a, b in zip(bounds[:-1], bounds[1:])]


def convert_3d(path):
    """Ingest the MATLAB-exported HumanEva streams.

    The 3D branch of the reference's ``data/prepare_data_humaneva.py``.
    Mocap dropouts (NaN frames) split each action
    into separately-named ``<action> chunkN`` clips; a chunk is kept only if
    its 3D stream is fully finite, and the 2D ground truth is cut at its own
    finiteness boundaries (span k of the 2D stream pairs with span k of the
    3D stream).

    Returns ``(poses_world, poses_image, span_table, joint_count)`` where
    ``span_table[subject][action]`` lists
    ``(start, stop, usable, split, chunk_name)`` in dataset frame numbers
    (used later to cut external detections at the same boundaries).
    """
    from scipy.io import loadmat

    poses_world = {s: {} for s in SUBJECTS}   # 3D mocap, meters
    poses_image = {s: {} for s in SUBJECTS}   # GT 2D, per camera
    span_table = {}
    joint_count = None

    for subject in SUBJECTS:
        split, short_name = subject.split("/")
        per_action = span_table.setdefault(short_name, {})

        for mat_file in glob(os.path.join(path, subject, "*.mat")):
            stem = os.path.splitext(os.path.basename(mat_file))[0]
            action = stem.replace("_", " ")
            first, last = INDEX[subject][action]

            payload = loadmat(mat_file)
            world = payload["poses_3d"]                        # (T, J, 3) mm
            image = payload["poses_2d"].transpose(1, 0, 2, 3)  # (T, cam, J, 2)
            assert world.shape[0] == image.shape[0]
            assert world.shape[1] == image.shape[2]
            assert joint_count in (None, world.shape[1]), \
                "Joint number inconsistency among files"
            joint_count = world.shape[1]
            assert world.shape[0] == last - first  # sequence-length check

            spans_world = _finite_spans(world)
            spans_image = _finite_spans(image)
            assert len(spans_world) == len(spans_image)

            rows = per_action.setdefault(action, [])
            for k, (a, b, usable) in enumerate(spans_world):
                chunk = f"{action} chunk{k}"
                if usable:
                    poses_world[subject][chunk] = \
                        world[a:b].astype(np.float32) / 1000
                    a2, b2, _ = spans_image[k]
                    per_camera = image[a2:b2].astype(np.float32)
                    poses_image[subject][chunk] = \
                        list(per_camera.transpose(1, 0, 2, 3))
                rows.append((first + a, first + b, usable, split, chunk))
            assert first + world.shape[0] == last

    return poses_world, poses_image, span_table, joint_count


def convert_2d(detections_path, output_suffix, span_table, data_dir,
               layout_prefix):
    """Align external 2D detections with the mocap chunking.

    The 2D branch of the reference's ``data/prepare_data_humaneva.py``.
    Each per-camera detection file is shifted by the published
    camera sync offset, then cut at the span boundaries recorded by
    :func:`convert_3d`; subjects/actions without mocap land under
    ``Unlabeled/``.
    """
    importer = suggest_pose_importer(output_suffix)
    metadata = suggest_metadata(output_suffix)

    print("Parsing 2D detections from", detections_path)
    archive = {}

    def slot(subject_key, clip_key):
        """Per-camera 3-slot list for one (subject, clip), created lazily."""
        return archive.setdefault(subject_key, {}).setdefault(
            clip_key, [None, None, None])

    for det_file in glob(detections_path + "/S*/*.avi.npz"):
        folder, det_name = os.path.split(det_file)
        subject = os.path.basename(folder)
        assert subject.startswith("S"), (
            subject + " does not look like a subject directory")

        parsed = re.match(r"(.*) \((.*)\)", det_name.replace("_", " "))
        action, cam = parsed.group(1), CAM_MAP[parsed.group(2)]

        detections = importer(det_file)
        assert detections.shape[1] == metadata["num_joints"]

        skip = SYNC_DATA.get(subject, {}).get(action)
        shift = 0 if skip is None else skip[cam] - 1

        spans = span_table.get(subject, {}).get(action)
        if spans is None:
            # No mocap for this take at all: keep the whole video unlabeled.
            slot("Unlabeled/" + subject, action)[cam] = \
                detections.astype(np.float32)
            continue

        for start, stop, usable, split, chunk in spans:
            key = f"{split}/{subject}"
            if not usable:
                key = "Unlabeled/" + key
            window = detections[start + shift:stop + shift]
            assert len(window) == stop - start, (
                f"Got len {len(window)}, expected {stop - start}")
            slot(key, chunk)[cam] = window.astype(np.float32)

    print("Saving...")
    np.savez_compressed(
        os.path.join(data_dir, layout_prefix + output_suffix + ".npz"),
        positions_2d=archive, metadata=metadata)
    print("Done.")


def main(argv=None):
    parser = argparse.ArgumentParser(description="HumanEva dataset converter")
    parser.add_argument("-p", "--path", default="", type=str, metavar="PATH",
                        help="path to the processed HumanEva dataset")
    parser.add_argument("--convert-3d", action="store_true",
                        help="convert 3D mocap data")
    parser.add_argument("--convert-2d", default="", type=str, metavar="PATH",
                        help="convert user-supplied 2D detections")
    parser.add_argument("-o", "--output", default="", type=str, metavar="PATH",
                        help="output suffix for 2D detections")
    parser.add_argument("--data-dir", default="data", type=str, metavar="PATH")
    args = parser.parse_args(argv)

    if not args.convert_2d and not args.convert_3d:
        parser.error("Please specify one conversion mode")
    if not args.path:
        parser.error("Please specify the dataset source")

    print("Parsing HumanEva dataset from", args.path)
    output, output_2d, frame_mapping, num_joints = convert_3d(args.path)

    metadata = suggest_metadata("humaneva" + str(num_joints))
    os.makedirs(args.data_dir, exist_ok=True)
    layout = metadata["layout_name"]

    if args.convert_3d:
        print("Saving...")
        np.savez_compressed(
            os.path.join(args.data_dir, "data_3d_" + layout + ".npz"),
            positions_3d=output)
        np.savez_compressed(
            os.path.join(args.data_dir, "data_2d_" + layout + "_gt.npz"),
            positions_2d=output_2d, metadata=metadata)
        print("Done.")

    if args.convert_2d:
        if not args.output:
            parser.error("Please specify an output suffix")
        convert_2d(args.convert_2d, args.output, frame_mapping, args.data_dir,
                   "data_2d_" + layout + "_")


if __name__ == "__main__":
    main()
