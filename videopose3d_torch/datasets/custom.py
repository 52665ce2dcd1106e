"""Custom (in-the-wild) dataset: one "subject" per video, no 3D ground truth.

Same API as ``videopose3d_tpu/datasets/custom.py`` (the reference's
``common/custom_dataset.py``).  Resolutions come from the 2D-detection archive's
``video_metadata``; the extrinsics are dummy Human3.6M values, used only so that
rendered reconstructions sit in a sane world frame.
"""

from __future__ import annotations

import numpy as np

from videopose3d_torch.datasets.h36m import H36M_STATIC_JOINTS, h36m_skeleton
from videopose3d_torch.datasets.mocap import MocapDataset

_DUMMY_ORIENTATION = (0.1407056450843811, -0.1500701755285263,
                      -0.755240797996521, 0.6223280429840088)
_DUMMY_TRANSLATION = (1841.1070556640625, 4955.28466796875, 1563.4454345703125)


class CustomDataset(MocapDataset):
    def __init__(self, detections_path, remove_static_joints=True):
        super().__init__(fps=None, skeleton=h36m_skeleton())

        data = np.load(detections_path, allow_pickle=True)
        resolutions = data["metadata"].item()["video_metadata"]

        self._cameras = {}
        self._data = {}
        for video_name, res in resolutions.items():
            cam = {
                "id": video_name,
                "res_w": res["w"],
                "res_h": res["h"],
                "azimuth": np.float32(70),  # viz only
                "orientation": np.array(_DUMMY_ORIENTATION, dtype="float32"),
                "translation": np.array(_DUMMY_TRANSLATION, dtype="float32") / 1000,
            }
            self._cameras[video_name] = [cam]
            self._data[video_name] = {"custom": {"cameras": cam}}

        if remove_static_joints:
            self.remove_joints(H36M_STATIC_JOINTS)
            self._skeleton.reparent(11, 8)
            self._skeleton.reparent(14, 8)

    def supports_semi_supervised(self) -> bool:
        return False
