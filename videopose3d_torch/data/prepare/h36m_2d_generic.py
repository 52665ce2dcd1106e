"""Generic per-video 2D detection converter for Human3.6M.

Same as ``videopose3d_tpu/data/prepare/h36m_2d_generic.py`` (the reference's
``data/prepare_data_2d_h36m_generic.py``): converts a directory tree
``S*/<Action>.<cam_id>.mp4.npz`` of per-video
detections (Detectron / CPN / SH, inferred from the output suffix) into a
standard ``data_2d_h36m_<suffix>.npz`` archive.

Usage::

    python -m videopose3d_torch.data.prepare.h36m_2d_generic \
        -i /path/to/detections -o detectron_pt_coco [--data-dir data]
"""

from __future__ import annotations

import argparse
import os
import re
from glob import glob

import numpy as np

from videopose3d_torch.data.prepare.layouts import (
    suggest_metadata, suggest_pose_importer)

CAM_MAP = {"54138969": 0, "55011271": 1, "58860488": 2, "60457274": 3}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Human3.6M detections converter")
    parser.add_argument("-i", "--input", default="", type=str, metavar="PATH",
                        help="input path to 2D detections")
    parser.add_argument("-o", "--output", default="", type=str, metavar="PATH",
                        help="output suffix (e.g. detectron_pt_coco)")
    parser.add_argument("--data-dir", default="data", type=str, metavar="PATH")
    args = parser.parse_args(argv)

    if not args.input:
        parser.error("Please specify the input directory")
    if not args.output:
        parser.error("Please specify an output suffix (e.g. detectron_pt_coco)")

    import_func = suggest_pose_importer(args.output)
    metadata = suggest_metadata(args.output)

    print("Parsing 2D detections from", args.input)
    output = {}
    file_list = glob(args.input + "/S*/*.mp4.npz")
    for f in file_list:
        path, fname = os.path.split(f)
        subject = os.path.basename(path)
        assert subject.startswith("S"), (
            subject + " does not look like a subject directory")
        if "_ALL" in fname:
            continue

        m = re.search(r"(.*)\.([0-9]+)\.mp4\.npz", fname)
        action, camera = m.group(1), m.group(2)
        camera_idx = CAM_MAP[camera]
        if subject == "S11" and action == "Directions":
            continue  # corrupted video

        canonical_name = action.replace("TakingPhoto", "Photo") \
                               .replace("WalkingDog", "WalkDog")
        keypoints = import_func(f)
        assert keypoints.shape[1] == metadata["num_joints"]

        output.setdefault(subject, {})
        output[subject].setdefault(canonical_name, [None, None, None, None])
        output[subject][canonical_name][camera_idx] = keypoints.astype("float32")

    print("Saving...")
    os.makedirs(args.data_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(args.data_dir, "data_2d_h36m_" + args.output + ".npz"),
        positions_2d=output, metadata=metadata)
    print("Done.")


if __name__ == "__main__":
    main()
