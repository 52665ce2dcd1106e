"""Human3.6M 3D archive converter + ground-truth 2D projection.

Same as ``videopose3d_tpu/data/prepare/h36m_3d.py`` (the reference's
``data/prepare_data_h36m.py``): three
ingest paths (Martinez-preprocessed .h5 zip, MATLAB-converted ``.cdf.mat``, raw
``.cdf`` via cdflib), mm->m conversion, the corrupted ``S11/Directions`` video
dropped, TakingPhoto->Photo / WalkingDog->WalkDog canonicalization, and GT 2D
generation by projecting the mocap through every camera.

Usage::

    python -m videopose3d_torch.data.prepare.h36m_3d --from-archive h36m.zip \
        [--data-dir data]
"""

from __future__ import annotations

import argparse
import os
import zipfile
from glob import glob
from shutil import rmtree

import numpy as np

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]


def _canonical(action: str) -> str:
    return action.replace("TakingPhoto", "Photo").replace("WalkingDog", "WalkDog")


def _harvest(root: str, take_glob: str, read_take, ext_depth: int,
             rename: bool) -> dict:
    """Shared ingest loop over the three on-disk formats.

    Walks every subject directory under ``root``, sanity-checks the take
    count (30 per subject), strips ``ext_depth`` filename extensions to get
    the action name, drops the corrupted ``S11/Directions`` take, optionally
    canonicalizes action names, and converts millimeters to meters.

    ``read_take(path)`` returns the raw ``(T, 32, 3)`` mocap array for one
    file; everything else is format-independent.
    """
    dataset = {}
    for subject in SUBJECTS:
        takes = glob(os.path.join(root, subject, take_glob))
        assert len(takes) == 30, (
            f"Expected 30 files for subject {subject}, got {len(takes)}")
        clips = dataset.setdefault(subject, {})
        for path in takes:
            name = os.path.basename(path)
            for _ in range(ext_depth):
                name = os.path.splitext(name)[0]
            if (subject, name) == ("S11", "Directions"):
                continue  # corrupted video, dropped by every ingest path
            mm = read_take(path)
            clips[_canonical(name) if rename else name] = \
                (mm / 1000.0).astype(np.float32)
    return dataset


def convert_from_archive(archive_path: str, workdir: str) -> dict:
    """Martinez et al. preprocessed zip of per-action .h5 files."""
    import h5py

    def read_take(path):
        with h5py.File(path, "r") as hf:
            flat = hf["3D_positions"][()]          # (96, T) joint-major
        return flat.reshape(32, 3, -1).transpose(2, 0, 1)

    print("Extracting Human3.6M dataset from", archive_path)
    with zipfile.ZipFile(archive_path, "r") as archive:
        archive.extractall(workdir)
    print("Converting...")
    dataset = _harvest(os.path.join(workdir, "h36m"),
                       "MyPoses/3D_positions/*.h5", read_take,
                       ext_depth=1, rename=False)
    rmtree(os.path.join(workdir, "h36m"))
    return dataset


def convert_from_source_mat(source_path: str) -> dict:
    """Original dataset pre-converted to .cdf.mat by data/convert_cdf_to_mat.m."""
    from scipy.io import loadmat

    def read_take(path):
        return loadmat(path)["data"][0, 0].reshape(-1, 32, 3)

    return _harvest(source_path, "MyPoseFeatures/D3_Positions/*.cdf.mat",
                    read_take, ext_depth=2, rename=True)


def convert_from_source_cdf(source_path: str) -> dict:
    """Original dataset via raw .cdf files (requires cdflib)."""
    import cdflib

    def read_take(path):
        return cdflib.CDF(path)["Pose"].reshape(-1, 32, 3)

    return _harvest(source_path, "MyPoseFeatures/D3_Positions/*.cdf",
                    read_take, ext_depth=1, rename=True)


def generate_gt_2d(dataset_path: str, output_path_2d: str):
    """Project mocap through every camera to produce GT 2D keypoints in pixel
    space, on numpy, bitwise as the JAX package's tool."""
    from videopose3d_torch.datasets.h36m import Human36mDataset
    from videopose3d_torch.ops.camera import (
        world_to_camera, project_to_2d_np, image_coordinates)

    print("Computing ground-truth 2D poses...")
    dataset = Human36mDataset(dataset_path)
    output_2d_poses = {}
    for subject in dataset.subjects():
        output_2d_poses[subject] = {}
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            positions_2d = []
            for cam in anim["cameras"]:
                pos_3d = world_to_camera(
                    anim["positions"], R=cam["orientation"], t=cam["translation"])
                pos_2d = project_to_2d_np(pos_3d[None], cam["intrinsic"][None])[0]
                pos_2d_pixel = image_coordinates(pos_2d, w=cam["res_w"], h=cam["res_h"])
                positions_2d.append(pos_2d_pixel.astype("float32"))
            output_2d_poses[subject][action] = positions_2d

    metadata = {
        "layout_name": "h36m",
        "num_joints": dataset.skeleton().num_joints(),
        "keypoints_symmetry": [dataset.skeleton().joints_left(),
                               dataset.skeleton().joints_right()],
    }
    np.savez_compressed(output_path_2d, positions_2d=output_2d_poses,
                        metadata=metadata)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Human3.6M dataset downloader/converter")
    parser.add_argument("--from-archive", default="", type=str, metavar="PATH",
                        help="convert preprocessed dataset (Martinez et al. zip)")
    parser.add_argument("--from-source", default="", type=str, metavar="PATH",
                        help="convert original dataset (.cdf.mat, needs MATLAB)")
    parser.add_argument("--from-source-cdf", default="", type=str, metavar="PATH",
                        help="convert original dataset (.cdf, needs cdflib)")
    parser.add_argument("--data-dir", default="data", type=str, metavar="PATH",
                        help="output directory for the archives")
    args = parser.parse_args(argv)

    if sum(bool(x) for x in
           (args.from_archive, args.from_source, args.from_source_cdf)) != 1:
        parser.error("specify exactly one dataset source")

    os.makedirs(args.data_dir, exist_ok=True)
    out_3d = os.path.join(args.data_dir, "data_3d_h36m.npz")
    out_2d = os.path.join(args.data_dir, "data_2d_h36m_gt.npz")
    if os.path.exists(out_3d):
        print("The dataset already exists at", out_3d)
        raise SystemExit(0)

    if args.from_archive:
        output = convert_from_archive(args.from_archive, args.data_dir)
    elif args.from_source:
        output = convert_from_source_mat(args.from_source)
    else:
        output = convert_from_source_cdf(args.from_source_cdf)

    print("Saving...")
    np.savez_compressed(out_3d, positions_3d=output)
    generate_gt_2d(out_3d, out_2d)
    print("Done.")


if __name__ == "__main__":
    main()
