"""Animation rendering: a 2D input viewport plus one 3D viewport per pose series.

Counterpart of ``videopose3d_tpu/visualization.py``, kept in the port because
the port imports nothing of the JAX package: the same artists, frames and
output bytes.  numpy and matplotlib only (no torch); the runner imports it only
when ``--viz-output`` asks for a rendering.

Each skeleton is one ``LineCollection`` / ``Line3DCollection`` artist updated
from bone-segment arrays per frame, and video metadata comes from one ffprobe
call.  ffmpeg/ffprobe are optional: black-background rendering always works,
GIF (and other PIL-readable) overlay videos decode through PIL when ffmpeg is
absent, and only formats PIL cannot read (e.g. mp4) raise a clear error then.
GIF export uses matplotlib's ``pillow`` writer; mp4 export needs ffmpeg.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Iterator, Optional, Tuple

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.animation import FuncAnimation, writers  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402
from mpl_toolkits.mplot3d.art3d import Line3DCollection  # noqa: E402

_AXIS_SPAN = 1.7  # metres of world space shown around the subject


def _need(tool: str) -> None:
    if shutil.which(tool) is None:
        raise RuntimeError(f"'{tool}' is required to decode input video but "
                           "was not found on PATH (GIF and other PIL-readable "
                           "animations decode without it)")


def _pil_animation(path: str):
    """Open ``path`` as a multi-frame PIL image, or return None.

    Fallback decode path for machines without ffmpeg: covers GIF (and any
    other animation format PIL reads), which is also what our own renderer
    emits — so render-with-overlay round-trips without external tools.

    Only animation *containers* qualify: a still image that PIL happens to
    read (a PNG passed by mistake) must NOT silently become a one-frame
    50 fps "video" — returning None lets the caller raise the
    ffmpeg/ffprobe-missing error instead.  A single-frame GIF still counts:
    our own renderer legitimately emits one for 1-frame clips and the
    round-trip must keep working without ffmpeg."""
    try:
        from PIL import Image
        im = Image.open(path)
        animation = (getattr(im, "n_frames", 1) > 1
                     or getattr(im, "is_animated", False)
                     or im.format == "GIF")
        if not animation:
            im.close()
            return None
        im.seek(0)
        return im
    except Exception:
        return None


def probe_video(path: str) -> Tuple[int, int, float]:
    """Return (width, height, fps) of the first video stream (one ffprobe call)."""
    if shutil.which("ffprobe") is None:
        im = _pil_animation(path)
        if im is not None:
            with im:
                duration_ms = im.info.get("duration")
                fps = 1000.0 / duration_ms if duration_ms else 50.0
                return im.width, im.height, fps
        _need("ffprobe")
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height,r_frame_rate", "-of", "csv=p=0", path],
        check=True, capture_output=True, text=True).stdout
    width, height, rate = out.strip().split("\n")[0].split(",")
    num, den = rate.split("/")
    return int(width), int(height), int(num) / int(den)


def get_resolution(path: str) -> Tuple[int, int]:
    w, h, _ = probe_video(path)
    return w, h


def get_fps(path: str) -> float:
    return probe_video(path)[2]


def read_video(path: str, skip: int = 0, limit: int = -1
               ) -> Iterator[np.ndarray]:
    """Yield RGB24 frames via an ffmpeg raw pipe: 1-indexed frames
    ``skip+1 .. limit`` (``limit`` is an absolute frame-index cap, as in the
    reference's ``common/visualization.py``; -1 = all)."""
    if shutil.which("ffmpeg") is None:
        im = _pil_animation(path)
        if im is not None:
            from PIL import ImageSequence
            with im:
                for index, frame in enumerate(ImageSequence.Iterator(im), 1):
                    if limit >= 0 and index > limit:
                        break
                    if index <= skip:
                        continue
                    yield np.asarray(frame.convert("RGB"), np.uint8)
            return
        _need("ffmpeg")
    width, height, _ = probe_video(path)
    frame_bytes = width * height * 3
    proc = subprocess.Popen(
        ["ffmpeg", "-nostdin", "-i", path, "-f", "rawvideo", "-pix_fmt",
         "rgb24", "-vsync", "0", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, bufsize=frame_bytes)
    try:
        index = 0
        while True:
            chunk = proc.stdout.read(frame_bytes)
            if len(chunk) < frame_bytes:
                break
            index += 1
            if limit >= 0 and index > limit:
                break
            if index <= skip:
                continue
            yield np.frombuffer(chunk, np.uint8).reshape(height, width, 3)
    finally:
        proc.stdout.close()
        proc.terminate()
        proc.wait()


def downsample_tensor(x: np.ndarray, factor: int) -> np.ndarray:
    """Mean-pool along the leading (time) axis by an integer factor."""
    usable = (x.shape[0] // factor) * factor
    return x[:usable].reshape(-1, factor, *x.shape[1:]).mean(axis=1)


class _SceneArtists:
    """All mutable artists for one rendered scene, updated vectorized per frame.

    One ``LineCollection`` carries every 2D bone, one ``Line3DCollection`` per
    3D viewport carries every 3D bone; per-frame updates are a single
    ``set_segments`` call each instead of a Python loop over Line2D objects.
    """

    def __init__(self, fig, n_views: int, azim: float, titles):
        self.ax_in = fig.add_subplot(1, 1 + n_views, 1)
        self.ax_in.set_axis_off()
        self.ax_in.set_title("Input")
        self.image = None
        self.joint_dots = None
        self.bones_2d = None
        self.bones_3d = []
        self.ax_3d = []
        for k, title in enumerate(titles):
            ax = fig.add_subplot(1, 1 + n_views, k + 2, projection="3d")
            ax.view_init(elev=15.0, azim=azim)
            ax.set_zlim3d([0, _AXIS_SPAN])
            try:
                ax.set_aspect("equal")
            except NotImplementedError:
                ax.set_aspect("auto")
            ax.set_xticklabels([])
            ax.set_yticklabels([])
            ax.set_zticklabels([])
            try:
                ax.dist = 7.5
            except AttributeError:
                pass  # attribute removed in newer matplotlib
            ax.set_title(title)
            self.ax_3d.append(ax)

    def follow(self, view: int, xy: np.ndarray) -> None:
        """Centre a 3D viewport's x/y limits on the subject's trajectory."""
        half = _AXIS_SPAN / 2
        ax = self.ax_3d[view]
        ax.set_xlim3d([xy[0] - half, xy[0] + half])
        ax.set_ylim3d([xy[1] - half, xy[1] + half])


def _bone_segments(pose: np.ndarray, children: np.ndarray,
                   parents: np.ndarray) -> np.ndarray:
    """(n_bones, 2, D) segment array for one pose (J, D)."""
    return np.stack([pose[children], pose[parents]], axis=1)


def render_animation(keypoints, keypoints_metadata, poses, skeleton, fps,
                     bitrate, azim, output, viewport, limit=-1, downsample=1,
                     size=6, input_video_path=None, input_video_skip=0):
    """Render the 2D inputs next to one 3D subplot per pose series (e.g.
    reconstruction + ground truth), with trajectory-following 3D axes.

    Output format is chosen by extension: ``.mp4`` (ffmpeg writer) or ``.gif``
    (pillow writer); any other extension raises ``ValueError``.
    """
    titles = list(poses.keys())
    series = [np.asarray(p) for p in poses.values()]
    trajectories = [p[:, 0, :2] for p in series]
    keypoints = np.asarray(keypoints)

    # -- background frames -------------------------------------------------
    if input_video_path is None:
        # 3-channel zeros: a 2-D array would go through imshow's default
        # colormap and render viridis-purple, not black.
        background = np.zeros(
            (keypoints.shape[0], viewport[1], viewport[0], 3), np.uint8)
        if fps is None:
            # Wild/custom datasets carry no frame rate and there is no source
            # video to probe; pick a sane playback default.
            print("INFO: unknown frame rate, assuming 50 FPS")
            fps = 50
    else:
        frames = list(read_video(input_video_path, skip=input_video_skip,
                                 limit=limit))
        n = min(keypoints.shape[0], len(frames))
        background = np.stack(frames[:n]) if n else np.zeros(
            (0, viewport[1], viewport[0], 3), np.uint8)
        keypoints = keypoints[input_video_skip:]
        series = [p[input_video_skip:] for p in series]
        # Trim the trajectories with the same skip — the 3D axis-follow would
        # otherwise center on a viewport `skip` frames ahead of the drawn
        # skeleton.  (The reference has this misalignment; fixed here.)
        trajectories = [t[input_video_skip:] for t in trajectories]
        if fps is None:
            fps = probe_video(input_video_path)[2]

    # -- temporal downsampling ---------------------------------------------
    if downsample > 1:
        keypoints = downsample_tensor(keypoints, downsample)
        background = downsample_tensor(
            np.asarray(background), downsample).astype(np.uint8)
        series = [downsample_tensor(p, downsample) for p in series]
        trajectories = [downsample_tensor(t, downsample)
                        for t in trajectories]
        fps /= downsample

    total = len(background) if limit < 1 else min(limit, len(background))
    # The skip trim can leave fewer pose frames than decoded backgrounds.
    total = min([total, len(keypoints)] + [len(p) for p in series])

    # -- static skeleton structure ------------------------------------------
    parent_of = np.asarray(skeleton.parents())
    bone_child = np.flatnonzero(parent_of >= 0)
    bone_parent = parent_of[bone_child]
    is_right = np.zeros(len(parent_of), bool)
    is_right[skeleton.joints_right()] = True
    bone_colors_3d = np.where(is_right[bone_child], "red", "black")

    dot_colors = np.full(keypoints.shape[1], "black", object)
    dot_colors[keypoints_metadata["keypoints_symmetry"][1]] = "red"
    # A 2D skeleton overlay only makes sense when the detector layout matches
    # the 3D skeleton's joint set.
    # .get: archives from the reference's own prep scripts omit layout_name.
    overlay_2d = (len(parent_of) == keypoints.shape[1]
                  and keypoints_metadata.get("layout_name") != "coco")

    # -- figure & artists -----------------------------------------------------
    plt.ioff()
    fig = plt.figure(figsize=(size * (1 + len(series)), size))
    scene = _SceneArtists(fig, len(series), azim, titles)

    def draw(i):
        for view, traj in enumerate(trajectories):
            scene.follow(view, traj[i])

        if scene.image is None:  # first frame: create the artists
            scene.image = scene.ax_in.imshow(background[i], aspect="equal")
            if overlay_2d:
                scene.bones_2d = LineCollection(
                    _bone_segments(keypoints[i], bone_child, bone_parent),
                    colors="pink")
                scene.ax_in.add_collection(scene.bones_2d)
            for view, ax in enumerate(scene.ax_3d):
                coll = Line3DCollection(
                    _bone_segments(series[view][i], bone_child, bone_parent),
                    colors=bone_colors_3d)
                ax.add_collection3d(coll)
                scene.bones_3d.append(coll)
            scene.joint_dots = scene.ax_in.scatter(
                *keypoints[i].T, 10, color=dot_colors, edgecolors="white",
                zorder=10)
        else:
            scene.image.set_data(background[i])
            if overlay_2d:
                scene.bones_2d.set_segments(
                    _bone_segments(keypoints[i], bone_child, bone_parent))
            for view, coll in enumerate(scene.bones_3d):
                coll.set_segments(
                    _bone_segments(series[view][i], bone_child, bone_parent))
            scene.joint_dots.set_offsets(keypoints[i])

        print(f"frame {i + 1}/{total}   ", end="\r")

    fig.tight_layout()
    anim = FuncAnimation(fig, draw, frames=np.arange(total),
                         interval=1000 / fps, repeat=False)
    if output.endswith(".mp4"):
        if "ffmpeg" not in writers.list():
            raise RuntimeError("matplotlib's ffmpeg writer is unavailable "
                               "(ffmpeg not installed); use a .gif output")
        anim.save(output, writer=writers["ffmpeg"](
            fps=fps, metadata={}, bitrate=bitrate))
    elif output.endswith(".gif"):
        # Heavy downsampling can push the effective rate under 0.5 fps;
        # int(round(...)) would hand PillowWriter fps=0 and its 1000/fps
        # frame-duration math would ZeroDivisionError AFTER the full render.
        anim.save(output, dpi=80, writer="pillow",
                  fps=max(1, int(round(fps))))
    else:
        raise ValueError("unsupported output extension "
                         f"'{output}' (expected .mp4 or .gif)")
    plt.close(fig)
