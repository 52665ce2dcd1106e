"""HumanEva-I dataset: 15-joint skeleton + published camera extrinsics.

Same data as ``videopose3d_tpu/datasets/humaneva.py`` (the reference's
``common/humaneva_dataset.py``).  Camera constants are public HumanEva-I
calibration facts.  The camera table is replicated under every subject-split
prefix the preparation CLI emits (``Train/S1``, ``Validate/S1``,
``Unlabeled/...``).  The cameras carry no intrinsics, so the dataset does not
support semi-supervised training.
"""

from __future__ import annotations

import numpy as np

from videopose3d_torch.datasets.mocap import MocapDataset
from videopose3d_torch.skeleton import Skeleton


def humaneva_skeleton() -> Skeleton:
    return Skeleton(
        parents=[-1, 0, 1, 2, 3, 1, 5, 6, 0, 8, 9, 0, 11, 12, 1],
        joints_left=[2, 3, 4, 8, 9, 10],
        joints_right=[5, 6, 7, 11, 12, 13],
    )


# (id, res_w, res_h, azimuth-for-viz) per camera.
_INTRINSICS = [
    ("C1", 640, 480, 0),
    ("C2", 640, 480, -90),
    ("C3", 640, 480, 90),
]

# Subject -> per-camera (orientation wxyz, translation mm); S4 has none.
_EXTRINSICS = {
    "S1": [
        ((0.424207, -0.4983646, -0.5802981, 0.4847012),
         (4062.227, 663.2477, 1528.397)),
        ((0.6503354, -0.7481602, -0.0919284, 0.0941766),
         (844.8131, -3805.2092, 1504.9929)),
        ((0.0664734, -0.0690535, 0.7416416, -0.6639132),
         (-797.67377, 3916.3174, 1433.6602)),
    ],
    "S2": [
        ((0.4214752, -0.4961493, -0.5838273, 0.4851187),
         (4112.9121, 626.4929, 1545.2988)),
        ((0.6501393, -0.7476588, -0.0954617, 0.0959808),
         (923.5740, -3877.9243, 1504.5518)),
        ((0.0699353, -0.0712403, 0.7421637, -0.662742),
         (-781.4915, 3838.8853, 1444.9929)),
    ],
    "S3": [
        ((0.424207, -0.4983646, -0.5802981, 0.4847012),
         (4062.2271, 663.2477, 1528.3970)),
        ((0.6503354, -0.7481602, -0.0919284, 0.0941766),
         (844.8131, -3805.2092, 1504.9929)),
        ((0.0664734, -0.0690535, 0.7416416, -0.6639132),
         (-797.6738, 3916.3174, 1433.6602)),
    ],
    "S4": [None, None, None],
}

_SUBJECT_PREFIXES = ["Train/", "Validate/", "Unlabeled/Train/",
                     "Unlabeled/Validate/", "Unlabeled/"]


def _build_camera(cam_idx: int, extrinsic) -> dict:
    cam_id, res_w, res_h, azimuth = _INTRINSICS[cam_idx]
    cam = {"id": cam_id, "res_w": res_w, "res_h": res_h,
           "azimuth": np.float32(azimuth)}
    if extrinsic is not None:
        cam["orientation"] = np.array(extrinsic[0], dtype="float32")
        cam["translation"] = np.array(extrinsic[1], dtype="float32") / 1000
    return cam


class HumanEvaDataset(MocapDataset):
    def __init__(self, path):
        super().__init__(fps=60, skeleton=humaneva_skeleton())

        base_cameras = {
            subject: [_build_camera(i, ext) for i, ext in enumerate(extrinsics)]
            for subject, extrinsics in _EXTRINSICS.items()
        }
        self._cameras = {}
        for subject, cams in base_cameras.items():
            for prefix in _SUBJECT_PREFIXES:
                self._cameras[prefix + subject] = cams

        data = np.load(path, allow_pickle=True)["positions_3d"].item()
        self._data = {}
        for subject, actions in data.items():
            self._data[subject] = {}
            for action_name, positions in actions.items():
                self._data[subject][action_name] = {
                    "positions": positions,
                    "cameras": self._cameras[subject],
                }
