"""Stacked Hourglass 2D detection archives for Human3.6M (MPII layout).

Same as ``videopose3d_tpu/data/prepare/h36m_2d_sh.py`` (the reference's
``data/prepare_data_2d_h36m_sh.py``):
unpacks the pretrained (zip) and fine-tuned (tar.gz) Stacked Hourglass detection
releases into standard 2D archives.

Usage::

    python -m videopose3d_torch.data.prepare.h36m_2d_sh -pt h36m_sh.zip \
        [-ft sh_ft.tar.gz] [--data-dir data]
"""

from __future__ import annotations

import argparse
import os
import tarfile
import zipfile
from glob import glob
from shutil import rmtree

import numpy as np

from videopose3d_torch.data.prepare.layouts import LAYOUTS

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]
CAM_MAP = {"54138969": 0, "55011271": 1, "58860488": 2, "60457274": 3}


def _process_subject(subject, file_list, output):
    import h5py
    expected = 119 if subject == "S11" else 120
    assert len(file_list) == expected, (
        f"Expected {expected} files for subject {subject}, got {len(file_list)}")
    for f in file_list:
        action, cam = os.path.splitext(
            os.path.basename(f))[0].replace("_", " ").split(".")
        if subject == "S11" and action == "Directions":
            continue  # corrupted video
        if action not in output[subject]:
            output[subject][action] = [None, None, None, None]
        with h5py.File(f, "r") as hf:
            positions = hf["poses"][()]
            output[subject][action][CAM_MAP[cam]] = positions.astype("float32")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Stacked Hourglass detections converter")
    parser.add_argument("-pt", "--pretrained", default="", type=str,
                        metavar="PATH", help="convert pretrained dataset")
    parser.add_argument("-ft", "--fine-tuned", default="", type=str,
                        metavar="PATH", help="convert fine-tuned dataset")
    parser.add_argument("--data-dir", default="data", type=str, metavar="PATH")
    args = parser.parse_args(argv)

    os.makedirs(args.data_dir, exist_ok=True)
    metadata = dict(LAYOUTS["mpii"])

    if args.pretrained:
        print("Converting pretrained dataset from", args.pretrained)
        workdir = os.path.join(args.data_dir, "sh_pt")
        with zipfile.ZipFile(args.pretrained, "r") as archive:
            archive.extractall(workdir)
        output = {}
        for subject in SUBJECTS:
            output[subject] = {}
            _process_subject(subject, glob(os.path.join(
                workdir, "h36m", subject, "StackedHourglass/*.h5")), output)
        np.savez_compressed(
            os.path.join(args.data_dir, "data_2d_h36m_sh_pt_mpii.npz"),
            positions_2d=output, metadata=metadata)
        rmtree(workdir)
        print("Done.")

    if args.fine_tuned:
        print("Converting fine-tuned dataset from", args.fine_tuned)
        workdir = os.path.join(args.data_dir, "sh_ft")
        with tarfile.open(args.fine_tuned, "r:gz") as archive:
            archive.extractall(workdir)
        output = {}
        for subject in SUBJECTS:
            output[subject] = {}
            _process_subject(subject, glob(os.path.join(
                workdir, subject, "StackedHourglassFineTuned240/*.h5")), output)
        np.savez_compressed(
            os.path.join(args.data_dir, "data_2d_h36m_sh_ft_h36m.npz"),
            positions_2d=output, metadata=metadata)
        rmtree(workdir)
        print("Done.")


if __name__ == "__main__":
    main()
