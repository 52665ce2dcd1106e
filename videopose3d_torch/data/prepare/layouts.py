"""Keypoint layout metadata + 2D-pose importers for the supported detectors.

Same as ``videopose3d_tpu/data/prepare/layouts.py`` (the reference's
``data/data_utils.py``).
The symmetry index lists are public layout definitions (MPII / COCO / H36M /
HumanEva-15/20).
"""

from __future__ import annotations

import numpy as np

LAYOUTS = {
    "mpii": {
        "layout_name": "mpii",
        "num_joints": 16,
        "keypoints_symmetry": [[3, 4, 5, 13, 14, 15], [0, 1, 2, 10, 11, 12]],
    },
    "coco": {
        "layout_name": "coco",
        "num_joints": 17,
        "keypoints_symmetry": [[1, 3, 5, 7, 9, 11, 13, 15],
                               [2, 4, 6, 8, 10, 12, 14, 16]],
    },
    "h36m": {
        "layout_name": "h36m",
        "num_joints": 17,
        "keypoints_symmetry": [[4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]],
    },
    "humaneva15": {
        "layout_name": "humaneva15",
        "num_joints": 15,
        "keypoints_symmetry": [[2, 3, 4, 8, 9, 10], [5, 6, 7, 11, 12, 13]],
    },
    "humaneva20": {
        "layout_name": "humaneva20",
        "num_joints": 20,
        "keypoints_symmetry": [[3, 4, 5, 6, 11, 12, 13, 14],
                               [7, 8, 9, 10, 15, 16, 17, 18]],
    },
}


def suggest_metadata(name: str) -> dict:
    """Pick a layout whose name appears in ``name`` (e.g. an output suffix)."""
    for layout in LAYOUTS.values():
        if layout["layout_name"] in name:
            return dict(layout)
    raise KeyError(
        f'Cannot infer keypoint layout from name "{name}". '
        f"Tried {list(LAYOUTS)}.")


def import_detectron_poses(path):
    """Detectron per-video .npz: best-scored detection per frame, soft-argmax
    coordinate rows.  Detection gaps are repaired by repeating the most recent
    pose (as the reference's ``data/data_utils.py`` does),
    implemented as a vectorized forward-fill index map."""
    archive = np.load(path, encoding="latin1", allow_pickle=True)
    picked = []
    found = []
    for frame_boxes, frame_kps in zip(archive["boxes"], archive["keypoints"]):
        candidates = frame_boxes[1]
        if len(candidates) == 0:
            found.append(False)
            continue
        winner = int(np.argmax(candidates[:, 4]))
        picked.append(frame_kps[1][winner].T.copy())
        found.append(True)
    found = np.asarray(found, bool)
    if found.size == 0 or not found[0]:
        raise ValueError(f"{path}: detector found nobody in the first frame")
    # Frame -> index of its most recent successful detection.
    source = np.cumsum(found) - 1
    poses = np.stack(picked)[source]
    if poses.shape[2] >= 6:
        return poses[:, :, 4:6]  # Detectron1 fork: soft-argmax rows
    if poses.shape[2] >= 2:
        # infer_video_d2.py packs 4 rows (x, y, logit, prob): the argmax
        # coordinates are the first two.  The reference importer would
        # silently return zero-width (T, J, 0) arrays here.
        return poses[:, :, :2]
    raise ValueError(
        f"{path}: keypoint packing has {poses.shape[2]} per-joint rows; "
        "expected >= 2 (x, y, ...)")


def import_cpn_poses(path):
    data = np.load(path)
    return data["keypoints"][:, :, :2]


def import_sh_poses(path):
    import h5py
    with h5py.File(path, "r") as hf:
        positions = hf["poses"][()]
    return positions.astype("float32")


def suggest_pose_importer(name: str):
    if "detectron" in name:
        return import_detectron_poses
    if "cpn" in name:
        return import_cpn_poses
    if "sh" in name:
        return import_sh_poses
    raise KeyError(
        f'Cannot infer keypoint format from name "{name}". '
        f"Tried detectron, cpn, sh.")
