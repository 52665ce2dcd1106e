"""The dataset-preparation CLIs of videopose3d_torch (``data/prepare/``) against the
JAX package's, on the same synthetic input trees (``tests/test_prepare_golden.py``'s
and ``tests/test_prepare.py``'s patterns): every archive bitwise equal, keys,
dtypes and values (pure numpy in both; the ground-truth 2D projection takes the
JAX package's numpy path operation for operation)."""

import os
import sys
import tarfile
import zipfile

import numpy as np
import pytest

from videopose3d_tpu.data.prepare import custom_2d as jcustom
from videopose3d_tpu.data.prepare import h36m_2d_generic as jgeneric
from videopose3d_tpu.data.prepare import h36m_2d_sh as jsh
from videopose3d_tpu.data.prepare import h36m_3d as jh36m
from videopose3d_tpu.data.prepare import humaneva as jhumaneva
from videopose3d_tpu.data.prepare import layouts as jlayouts
from videopose3d_torch.data.prepare import custom_2d, h36m_2d_generic, h36m_2d_sh, h36m_3d
from videopose3d_torch.data.prepare import humaneva, layouts

from tests.test_prepare import _make_detectron_npz
from tests.test_prepare_golden import _build_humaneva_inputs, _compare_archives


def _both(tmp_path, jax_main, port_main, argv, names):
    """Run both CLIs with ``argv`` + their own ``--data-dir``; compare the archives."""
    jax_main([*argv, "--data-dir", str(tmp_path / "jax")])
    port_main([*argv, "--data-dir", str(tmp_path / "port")])
    for name in names:
        _compare_archives(str(tmp_path / "jax" / name), str(tmp_path / "port" / name))


def test_layouts_match_jax(tmp_path):
    assert layouts.LAYOUTS == jlayouts.LAYOUTS
    for name in ("detectron_pt_coco", "sh_pt_mpii", "cpn_ft_h36m_dbb", "cpn_humaneva15",
                 "humaneva20"):
        assert layouts.suggest_metadata(name) == jlayouts.suggest_metadata(name)
    for name in ("detectron_x", "cpn_ft_h36m_dbb", "sh_pt_mpii"):
        ours, theirs = layouts.suggest_pose_importer(name), jlayouts.suggest_pose_importer(name)
        assert ours.__name__ == theirs.__name__
    with pytest.raises(KeyError):
        layouts.suggest_metadata("unknown_layout")
    with pytest.raises(KeyError):
        layouts.suggest_pose_importer("unknown_importer")


def test_pose_importers_match_jax(tmp_path):
    import h5py
    rng = np.random.default_rng(3)
    _make_detectron_npz(str(tmp_path / "det.npz"), n_frames=7, miss_frames=(3, 4))
    np.savez(tmp_path / "cpn.npz", keypoints=rng.random((7, 17, 3)).astype(np.float32))
    with h5py.File(tmp_path / "sh.h5", "w") as hf:
        hf["poses"] = rng.uniform(0, 1000, (7, 16, 2))
    for fn, path in (("import_detectron_poses", "det.npz"), ("import_cpn_poses", "cpn.npz"),
                     ("import_sh_poses", "sh.h5")):
        got = getattr(layouts, fn)(str(tmp_path / path))
        want = getattr(jlayouts, fn)(str(tmp_path / path))
        assert got.dtype == want.dtype and np.array_equal(got, want), fn


def test_custom_2d_cli_matches_jax(tmp_path):
    dets = tmp_path / "dets"
    dets.mkdir()
    _make_detectron_npz(str(dets / "a.mp4.npz"))
    _make_detectron_npz(str(dets / "b.mp4.npz"), n_frames=9, miss_frames=(0, 5, 8)[1:])
    _both(tmp_path, jcustom.main, custom_2d.main, ["-i", str(dets), "-o", "wild"],
          ["data_2d_custom_wild.npz"])


def test_humaneva_cli_matches_jax(tmp_path):
    """Chunks split at NaN frames, Unlabeled/ subjects and the camera sync
    offsets: the 3D, the ground-truth 2D and the detections archives."""
    src, dets = _build_humaneva_inputs(str(tmp_path), np.random.default_rng(7))
    _both(tmp_path, jhumaneva.main, humaneva.main,
          ["-p", src, "--convert-3d", "--convert-2d", dets, "-o", "cpn_humaneva15"],
          ["data_3d_humaneva15.npz", "data_2d_humaneva15_gt.npz",
           "data_2d_humaneva15_cpn_humaneva15.npz"])


_H36M_ACTIONS = [f"Act{i} 1" for i in range(27)] + ["Directions", "TakingPhoto 1",
                                                     "WalkingDog"]


def test_h36m_3d_from_archive_matches_jax(tmp_path):
    """The Martinez zip of .h5 takes: the 3D archive and the ground-truth 2D
    projected through every camera, bitwise."""
    import h5py
    rng = np.random.default_rng(17)
    zip_path = tmp_path / "h36m.zip"
    scratch = tmp_path / "take.h5"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for subject in h36m_3d.SUBJECTS:
            for action in _H36M_ACTIONS:
                with h5py.File(scratch, "w") as hf:
                    hf["3D_positions"] = rng.standard_normal((96, 5)) * 500
                zf.write(scratch, f"h36m/{subject}/MyPoses/3D_positions/{action}.h5")
    _both(tmp_path, jh36m.main, h36m_3d.main, ["--from-archive", str(zip_path)],
          ["data_3d_h36m.npz", "data_2d_h36m_gt.npz"])


def test_h36m_3d_from_source_mat_matches_jax(tmp_path):
    from scipy.io import savemat
    rng = np.random.default_rng(19)
    src = tmp_path / "source"
    for subject in h36m_3d.SUBJECTS:
        d = src / subject / "MyPoseFeatures" / "D3_Positions"
        d.mkdir(parents=True)
        for action in _H36M_ACTIONS:
            cell = np.empty((1, 1), dtype=object)
            cell[0, 0] = rng.standard_normal((5, 96)) * 500
            savemat(d / f"{action}.cdf.mat", {"data": cell})
    _both(tmp_path, jh36m.main, h36m_3d.main, ["--from-source", str(src)],
          ["data_3d_h36m.npz", "data_2d_h36m_gt.npz"])


def test_h36m_3d_cdf_source_needs_cdflib(tmp_path, monkeypatch):
    """The raw .cdf path imports cdflib only when it runs, as the JAX tool does:
    without it both raise the same ImportError and write nothing."""
    monkeypatch.setitem(sys.modules, "cdflib", None)
    errors = []
    for main, out in ((jh36m.main, "jax"), (h36m_3d.main, "port")):
        with pytest.raises(ImportError) as raised:
            main(["--from-source-cdf", str(tmp_path), "--data-dir", str(tmp_path / out)])
        errors.append(str(raised.value))
        assert not (tmp_path / out / "data_3d_h36m.npz").exists()
    assert errors[0] == errors[1] and "cdflib" in errors[1]


def test_h36m_2d_sh_cli_matches_jax(tmp_path):
    """Pretrained (zip) and fine-tuned (tar.gz) Stacked Hourglass releases,
    S11's corrupted Directions dropped."""
    import h5py
    rng = np.random.default_rng(11)
    actions = [f"Act{i}_1" for i in range(29)] + ["Directions"]
    cams = list(h36m_2d_sh.CAM_MAP)
    scratch = tmp_path / "take.h5"
    zip_path, tar_path = tmp_path / "sh.zip", tmp_path / "sh_ft.tar.gz"
    with zipfile.ZipFile(zip_path, "w") as zf, tarfile.open(tar_path, "w:gz") as tf:
        for subject in h36m_2d_sh.SUBJECTS:
            files = [(a, c) for a in actions for c in cams]
            if subject == "S11":
                files.remove(("Act0_1", cams[0]))  # the released set has 119
            for action, cam in files:
                with h5py.File(scratch, "w") as hf:
                    hf["poses"] = rng.uniform(0, 1000, (3, 16, 2))
                zf.write(scratch, f"h36m/{subject}/StackedHourglass/{action}.{cam}.h5")
                tf.add(scratch, f"{subject}/StackedHourglassFineTuned240/{action}.{cam}.h5")
    _both(tmp_path, jsh.main, h36m_2d_sh.main, ["-pt", str(zip_path), "-ft", str(tar_path)],
          ["data_2d_h36m_sh_pt_mpii.npz", "data_2d_h36m_sh_ft_h36m.npz"])


def test_h36m_2d_generic_cli_matches_jax(tmp_path):
    """Per-video detections: TakingPhoto / WalkingDog renamed, _ALL videos and
    S11's Directions skipped."""
    rng = np.random.default_rng(13)
    dets = tmp_path / "dets"
    cams = list(h36m_2d_generic.CAM_MAP)
    for subject in ["S1", "S9", "S11"]:
        (dets / subject).mkdir(parents=True)
        for action in ["Directions", "TakingPhoto 1", "WalkingDog"]:
            for cam in cams:
                np.savez(dets / subject / f"{action}.{cam}.mp4.npz",
                         keypoints=rng.uniform(0, 1000, (6, 17, 2)))
        np.savez(dets / subject / f"Everything_ALL.{cams[0]}.mp4.npz",
                 keypoints=rng.uniform(0, 1000, (6, 17, 2)))
    _both(tmp_path, jgeneric.main, h36m_2d_generic.main,
          ["-i", str(dets), "-o", "cpn_ft_h36m_dbb"], ["data_2d_h36m_cpn_ft_h36m_dbb.npz"])


def test_prepare_modules_run_as_cli_entry_points():
    """Each tool is a ``python -m`` module with a ``main(argv)``, and imports
    neither h5py, scipy nor cdflib when it loads."""
    for module in (custom_2d, h36m_2d_generic, h36m_2d_sh, h36m_3d, humaneva):
        assert callable(module.main)
        source = open(module.__file__).read()
        assert 'if __name__ == "__main__":' in source
        top = [line for line in source.splitlines() if line.startswith(("import ", "from "))]
        assert not any(name in line for line in top for name in ("h5py", "scipy", "cdflib"))
    assert os.path.basename(os.path.dirname(h36m_3d.__file__)) == "prepare"
