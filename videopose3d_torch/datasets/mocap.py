"""Mocap dataset abstraction.

Same API as ``videopose3d_tpu/datasets/mocap.py`` (the reference's
``common/mocap_dataset.py``): a dict-of-dicts ``data[subject][action]`` plus
per-subject camera lists, the skeleton, and fps.  Host-side only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from videopose3d_torch.skeleton import Skeleton


class MocapDataset:
    """Base class for mocap datasets.

    Subclasses populate ``_data`` (``{subject: {action: record}}`` where a
    record may hold ``positions`` (T, J, 3) world-space mocap and/or camera
    references) and ``_cameras`` (``{subject: [camera dict, ...]}``).
    """

    def __init__(self, fps: Optional[int], skeleton: Skeleton):
        self._fps = fps
        self._skeleton = skeleton
        self._data: Optional[Dict[str, Dict[str, Any]]] = None
        self._cameras: Optional[Dict[str, List[dict]]] = None

    # -- accessors ---------------------------------------------------------

    def subjects(self):
        return self._data.keys()

    def __getitem__(self, subject: str):
        return self._data[subject]

    def cameras(self):
        return self._cameras

    def fps(self):
        return self._fps

    def skeleton(self) -> Skeleton:
        return self._skeleton

    def supports_semi_supervised(self) -> bool:
        """Whether the dataset has the camera intrinsics the semi-supervised
        reconstruction loss projects with; subclasses opt in."""
        return False

    # -- mutation ----------------------------------------------------------

    def remove_joints(self, joints_to_remove) -> None:
        """Trim the skeleton and every loaded position array to the kept
        joints (e.g. Human3.6M 32 -> 17)."""
        kept = self._skeleton.remove_joints(joints_to_remove)
        for actions in self._data.values():
            for record in actions.values():
                if "positions" in record:
                    record["positions"] = record["positions"][:, kept]
