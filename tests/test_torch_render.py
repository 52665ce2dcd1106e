"""The rendering path of videopose3d_torch against videopose3d_tpu.

* The in-the-wild flow: synthetic Detectron detections -> the custom_2d
  archive -> ``-d custom --evaluate <checkpoint> --render --viz-export`` through
  both CLIs on one archive and one checkpoint (non-causal and causal, the plain
  and the fused engine, with and without a trajectory model).
* A Human3.6M rendering with ground truth and a GIF.
* ``evaluate(..., return_predictions=True)`` per engine.
* ``render_animation`` of both packages on the same arrays.

Exports agree within 1e-5 * max(1, max |pose|): the same float32 products
summed in other orders.
"""

import os

import numpy as np
import pytest
from PIL import Image, ImageSequence

from videopose3d_tpu import runner as jax_runner
from videopose3d_tpu.checkpoint import save_checkpoint
from videopose3d_tpu.data.prepare import custom_2d as jax_custom_2d
from videopose3d_tpu.models.convert import params_to_torch_state_dict
from videopose3d_torch import runner

from torch_port_helpers import jax_model, write_h36m_archives

POSE_TOL = 1e-5
CHANNELS = 16
# name -> (frames, width, height)
VIDEOS = {"walk.mp4": (70, 640, 480), "run.mp4": (55, 1920, 1080)}


def write_detections(root, seed=0):
    """One Detectron-format .npz per video: two people per frame (the
    best-scored one walks), and four frames without any detection."""
    rng = np.random.default_rng(seed)
    for name, (n, w, h) in VIDEOS.items():
        boxes, keypoints = np.empty((n, 2), object), np.empty((n, 2), object)
        centre = rng.uniform([0.3 * w, 0.3 * h], [0.7 * w, 0.7 * h])
        walk = (centre + rng.normal(0, 40, (17, 2))
                + np.cumsum(rng.normal(0, 3, (n, 17, 2)), axis=0))
        gaps = set(rng.choice(np.arange(1, n - 1), 4, replace=False).tolist())
        for i in range(n):
            boxes[i, 0], keypoints[i, 0] = [], []
            if i in gaps:
                boxes[i, 1] = np.zeros((0, 5), np.float32)
                keypoints[i, 1] = np.zeros((0, 4, 17), np.float32)
                continue
            people = rng.uniform(0, 1, (2, 4, 17)).astype(np.float32)
            people[0, :2] = walk[i].T
            people[1, :2] = rng.uniform(0, min(w, h), (2, 17))
            bbs = rng.uniform(0, 100, (2, 5)).astype(np.float32)
            bbs[:, 4] = [0.9, 0.3]
            boxes[i, 1], keypoints[i, 1] = bbs, people
        np.savez(os.path.join(root, name + ".npz"), boxes=boxes, keypoints=keypoints,
                 segments=np.array([None] * n, dtype=object), metadata={"w": w, "h": h})


def _payload(pose, traj=None):
    return {"epoch": 7, "lr": None, "optimizer": None, "random_state": None,
            "random_state_semi": None,
            "model_pos": params_to_torch_state_dict(pose[1], pose[2]),
            "model_traj": None if traj is None else params_to_torch_state_dict(
                traj[1], traj[2])}


@pytest.fixture(scope="module")
def wild(tmp_path_factory):
    """A custom_2d archive of VIDEOS and checkpoints with random weights and
    BatchNorm statistics: ``pose[_causal][_traj].bin``."""
    root = tmp_path_factory.mktemp("wild")
    dets, data, ckpt = root / "dets", root / "data", root / "ckpt"
    for d in (dets, data, ckpt):
        d.mkdir()
    write_detections(str(dets))
    jax_custom_2d.main(["-i", str(dets), "-o", "myvideos", "--data-dir", str(data)])
    for causal in (False, True):
        kwargs = dict(num_joints_in=17, in_features=2, num_joints_out=17,
                      filter_widths=(3, 3), channels=CHANNELS, causal=causal)
        pose = jax_model(kwargs, seed=3 + causal)
        traj = jax_model({**kwargs, "num_joints_out": 1}, seed=5 + causal)
        stem = "pose" + ("_causal" if causal else "")
        save_checkpoint(str(ckpt / f"{stem}.bin"), _payload(pose))
        save_checkpoint(str(ckpt / f"{stem}_traj.bin"), _payload(pose, traj))
    return root


def _wild_argv(root, checkpoint, causal, engine, export, video="walk.mp4"):
    return ["-d", "custom", "-k", "myvideos", "--data-dir", str(root / "data"),
            "-c", str(root / "ckpt"), "-arc", "3,3", "-ch", str(CHANNELS),
            "--eval-bucket", "16", "--evaluate", checkpoint, "--serving-engine", engine,
            "--render", "--viz-subject", video, "--viz-action", "custom",
            "--viz-camera", "0", "--viz-export", str(export),
            *(["--causal"] if causal else [])]


def _assert_poses_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    tol = POSE_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("traj", [False, True], ids=["pose", "with_traj"])
@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_wild_export_matches_jax(wild, causal, engine, traj, tmp_path, capsys):
    checkpoint = ("pose_causal" if causal else "pose") + ("_traj" if traj else "") + ".bin"
    jax_runner.main(_wild_argv(wild, checkpoint, causal, engine, tmp_path / "jax.npy")
                    + ["--rng-impl", "threefry2x32"])
    capsys.readouterr()
    runner.main(_wild_argv(wild, checkpoint, causal, engine, tmp_path / "port.npy")
                + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "INFO: this action is unlabeled. Ground truth will not be rendered." in out
    assert "Exporting joint positions to" in out
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == (VIDEOS["walk.mp4"][0], 17, 3)
    _assert_poses_close(got, want)
    if traj:  # the trajectory moves every joint alike
        runner.main(_wild_argv(wild, checkpoint.replace("_traj", ""), causal, engine,
                               tmp_path / "pose.npy") + ["--device", "cpu"])
        shift = got - np.load(tmp_path / "pose.npy")
        assert np.abs(shift).max() > 1e-3
        np.testing.assert_allclose(shift, np.broadcast_to(shift[:, :1], shift.shape),
                                   rtol=0, atol=1e-5)


def test_h36m_render_with_ground_truth(tmp_path, capsys):
    """--render of a labeled Human3.6M video: the export matches the JAX CLI's,
    and --viz-output writes a GIF of --viz-limit frames with three viewports
    whose decoded frames equal the JAX CLI's."""
    data, ckpt = tmp_path / "data", tmp_path / "ckpt"
    data.mkdir()
    ckpt.mkdir()
    write_h36m_archives(str(data), n_frames=40)
    pose = jax_model(dict(num_joints_in=17, in_features=2, num_joints_out=17,
                          filter_widths=(3, 3), channels=CHANNELS), seed=9)
    save_checkpoint(str(ckpt / "model.bin"), _payload(pose))

    def argv(name):
        return ["-k", "gt", "--data-dir", str(data), "-c", str(ckpt), "-arc", "3,3",
                "-ch", str(CHANNELS), "--eval-bucket", "16", "--evaluate", "model.bin",
                "--render", "--viz-subject", "S9", "--viz-action", "Walking 1",
                "--viz-camera", "1", "--viz-export", str(tmp_path / f"{name}.npy"),
                "--viz-output", str(tmp_path / f"{name}.gif"), "--viz-limit", "5",
                "--viz-size", "2"]

    jax_runner.main(argv("jax") + ["--rng-impl", "threefry2x32"])
    capsys.readouterr()
    runner.main(argv("port") + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Rendering..." in out and "this action is unlabeled" not in out
    assert "Protocol #1" not in out  # a rendering replaces the final evaluation
    _assert_poses_close(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    with Image.open(tmp_path / "port.gif") as got, Image.open(tmp_path / "jax.gif") as want:
        assert got.n_frames == want.n_frames == 5
        assert got.size == want.size == (2 * 3 * 80, 2 * 80)
    for g, w in zip(_frames(tmp_path / "port.gif")[0], _frames(tmp_path / "jax.gif")[0]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine", ["xla", "fused", "int8"])
def test_evaluate_returns_the_first_videos_prediction(engine):
    """evaluate(..., return_predictions=True): the first video's TTA-merged
    camera-space prediction from the serving engine, as the JAX package's."""
    from videopose3d_tpu.data.generators import UnchunkedBatcher as JBatcher
    from videopose3d_tpu.evaluate import Evaluator as JEvaluator, evaluate as jevaluate
    from videopose3d_torch.data.generators import UnchunkedBatcher
    from videopose3d_torch.evaluate import Evaluator, evaluate

    cfg, params, state, tcfg, model = jax_model(dict(
        num_joints_in=17, in_features=2, num_joints_out=17, filter_widths=(3, 3, 3),
        channels=CHANNELS), seed=11)
    rng = np.random.default_rng(12)
    videos = [rng.uniform(-1, 1, (n, 17, 2)).astype(np.float32) for n in (45, 30)]
    perm = np.arange(17)
    perm[[4, 5, 6, 11, 12, 13]], perm[[1, 2, 3, 14, 15, 16]] = (
        [1, 2, 3, 14, 15, 16], [4, 5, 6, 11, 12, 13])
    kw = dict(pad=13, augment=True, kps_flip_perm=perm, joints_flip_perm=perm, bucket=16)
    want = jevaluate(JEvaluator(cfg, joints_flip_perm=perm, engine=engine), params, state,
                     JBatcher(None, None, videos, **kw), return_predictions=True)
    got = evaluate(Evaluator(tcfg, joints_flip_perm=perm, engine=engine, device="cpu"),
                   model, UnchunkedBatcher(None, None, videos, **kw),
                   return_predictions=True)
    assert got.shape == np.asarray(want).shape == (45, 17, 3)
    if engine == "int8":  # one int8 rounding may flip at a tie (test_torch_int8.py)
        tol = 1e-3 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        _assert_poses_close(got, np.asarray(want))


def _tiny_scene(n):
    """A 3-joint chain with random keypoints and one pose series."""
    from videopose3d_tpu.skeleton import Skeleton as JSkeleton
    from videopose3d_torch.skeleton import Skeleton
    rng = np.random.default_rng(0)
    kps = rng.uniform(10, 90, (n, 3, 2)).astype(np.float32)
    poses = {"Reconstruction": rng.standard_normal((n, 3, 3)).astype(np.float32) * 0.1,
             "Ground truth": rng.standard_normal((n, 3, 3)).astype(np.float32) * 0.1}
    meta = {"layout_name": "h36m", "num_joints": 3, "keypoints_symmetry": [[1], [2]]}
    skeletons = [cls(parents=[-1, 0, 1], joints_left=[1], joints_right=[2])
                 for cls in (JSkeleton, Skeleton)]
    return kps, meta, poses, skeletons


def _frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)], \
            im.info.get("duration")


@pytest.mark.parametrize("case", ["plain", "sub_1fps_downsample", "video_overlay"])
def test_render_animation_matches_jax(case, tmp_path):
    from videopose3d_tpu import visualization as jvis
    from videopose3d_torch import visualization as vis
    n = 220 if case == "sub_1fps_downsample" else 8
    kps, meta, poses, (jskel, skel) = _tiny_scene(n)
    kw = dict(fps=50, bitrate=500, azim=70.0, viewport=(100, 100), size=2)
    if case == "sub_1fps_downsample":  # 220 frames / 101 -> 2 frames at ~0.495 fps
        kw["downsample"] = 101
    if case == "video_overlay":  # a GIF decoded through PIL, its first 2 frames skipped
        video = str(tmp_path / "in.gif")
        colours = [Image.new("RGB", (100, 100), (20 * i, 255 - 20 * i, 90))
                   for i in range(n)]
        colours[0].save(video, save_all=True, append_images=colours[1:], duration=20)
        kw.update(input_video_path=video, input_video_skip=2, fps=None)
    jvis.render_animation(kps, meta, poses, jskel, output=str(tmp_path / "jax.gif"), **kw)
    vis.render_animation(kps, meta, poses, skel, output=str(tmp_path / "port.gif"), **kw)
    got, want = _frames(tmp_path / "port.gif"), _frames(tmp_path / "jax.gif")
    assert len(got[0]) == len(want[0]) == {"plain": 8, "sub_1fps_downsample": 2,
                                           "video_overlay": 6}[case]
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    if case == "plain":
        with pytest.raises(ValueError, match="unsupported output extension"):
            vis.render_animation(kps, meta, poses, skel, output=str(tmp_path / "x.avi"),
                                 **kw)
