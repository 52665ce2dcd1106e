"""The benchmark's inputs, made from ``--seed``: model weights and the traffic
mixes' data.  One general generator per kind of data, driven by the parameters of
a ``traffic/*.json`` file; nothing here imports the program.

Weights and data are drawn on the device with a ``torch.Generator`` in a few large
calls.  Every seed gets the same sizes (the eval set's video lengths are one fixed
multiset, dealt to the videos in an order drawn from the seed), so a seed changes
the values and not the amount of work.
"""

from __future__ import annotations

import numpy as np
import torch

# Human3.6M's left / right joints, for 2D keypoints and 3D joints alike
# (17 joints; the reference's ``keypoints_symmetry`` and skeleton).
H36M_LEFT = [4, 5, 6, 11, 12, 13]
H36M_RIGHT = [1, 2, 3, 14, 15, 16]


def sub_seed(seed: int, salt: int, bits: int = 63) -> int:
    """An independent seed for one use (``salt``) of the run's ``--seed``."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, salt]).generate_state(1, np.uint64)
    return int(state[0]) >> (64 - bits)


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, salt))


def flip_perm(num_joints: int = 17):
    perm = np.arange(num_joints)
    perm[H36M_LEFT + H36M_RIGHT] = perm[H36M_RIGHT + H36M_LEFT]
    return perm


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def weight_shapes(cfg):
    """(name, shape, kind) of every tensor of the model's state dict, in the
    reference implementation's names."""
    c = cfg["channels"]
    fws = cfg["filter_widths"]
    c_in = cfg["num_joints_in"] * cfg["in_features"]
    out = [("expand_conv.weight", (c, c_in, fws[0]), "conv")]
    bns = ["expand_bn"]
    for i, fw in enumerate(fws[1:]):
        out.append((f"layers_conv.{2 * i}.weight", (c, c, fw), "conv"))
        out.append((f"layers_conv.{2 * i + 1}.weight", (c, c, 1), "conv"))
        bns += [f"layers_bn.{2 * i}", f"layers_bn.{2 * i + 1}"]
    for bn in bns:
        out += [(f"{bn}.weight", (c,), "bn_weight"), (f"{bn}.bias", (c,), "bn_bias"),
                (f"{bn}.running_mean", (c,), "bn_mean"),
                (f"{bn}.running_var", (c,), "bn_var")]
    j3 = cfg["num_joints_out"] * 3
    out += [("shrink.weight", (j3, c, 1), "conv"), ("shrink.bias", (j3,), "shrink_bias")]
    return out


def make_weights(cfg, seed: int, device):
    """float32 weights and BatchNorm statistics from one uniform draw: the
    convolutions as PyTorch initialises them (uniform within 1/sqrt(fan in)),
    BatchNorm scales in [0.5, 1.5], shifts in [-0.2, 0.2], running means in
    [-0.1, 0.1] and variances in [0.5, 2]."""
    shapes = weight_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    u = torch.rand(sum(sizes), generator=generator(seed, 1, device), device=device)
    ranges = {"bn_weight": (0.5, 1.5), "bn_bias": (-0.2, 0.2), "bn_mean": (-0.1, 0.1),
              "bn_var": (0.5, 2.0)}
    out, start = {}, 0
    for (name, shape, kind), n in zip(shapes, sizes):
        if kind == "conv":
            b = 1.0 / float(np.sqrt(shape[1] * shape[2]))
            lo, hi = -b, b
        elif kind == "shrink_bias":
            b = 1.0 / float(np.sqrt(cfg["channels"]))
            lo, hi = -b, b
        else:
            lo, hi = ranges[kind]
        out[name] = (u[start:start + n] * (hi - lo) + lo).reshape(shape)
        start += n
    return out


def load_into(module, weights) -> None:
    """Copy ``weights`` into a module whose state dict has these names."""
    state = module.state_dict()
    missing = [k for k in weights if k not in state]
    if missing:
        raise KeyError(f"the model has no {missing}")
    with torch.no_grad():
        for k, v in weights.items():
            state[k].copy_(v)


# ---------------------------------------------------------------------------
# Keypoint tracks
# ---------------------------------------------------------------------------


def _walks(gen, device, n_seq: int, lengths, joints: int, dims: int, base: float,
           step: float):
    """One random walk per sequence, (sum lengths, joints, dims) float32 on the
    host: a uniform base pose in [-base, base] and Gaussian steps of ``step``."""
    total = int(sum(lengths))
    steps = torch.randn(total, joints, dims, generator=gen, device=device) * step
    seq = torch.repeat_interleave(torch.arange(n_seq, device=device),
                                  torch.as_tensor(lengths, device=device))
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)[:-1]]), device=device)
    walk = steps.cumsum(0)
    walk -= (walk[starts] - steps[starts])[seq]  # each sequence starts its own walk
    bases = (torch.rand(n_seq, joints, dims, generator=gen, device=device) * 2 - 1) * base
    return (walk + bases[seq]).cpu().numpy()


def _split(flat, lengths):
    return np.split(flat, np.cumsum(lengths)[:-1])


def training_set(traffic, seed: int, device):
    """(poses_2d, poses_3d): ``sequences`` videos of ``frames_per_sequence``
    frames, 2D keypoints in normalised screen units and 3D joints in metres."""
    n, t = traffic["sequences"], traffic["frames_per_sequence"]
    gen = generator(seed, 2, device)
    lengths = [t] * n
    p2 = _walks(gen, device, n, lengths, 17, 2, 0.4, 0.003)
    p3 = _walks(gen, device, n, lengths, 17, 3, 0.5, 0.002)
    return _split(p2, lengths), _split(p3, lengths)


def eval_lengths(traffic):
    """The fixed multiset of take lengths (every seed's), uniform in
    [min_frames, max_frames] from ``lengths_seed``."""
    takes = traffic["subjects"] * traffic["actions"] * traffic["takes"]
    rng = np.random.default_rng(traffic["lengths_seed"])
    return rng.integers(traffic["min_frames"], traffic["max_frames"] + 1, takes)


def eval_set(traffic, seed: int, device):
    """The test set as actions: a list, one entry per action, of its videos
    ``(poses_2d (N, 17, 2), poses_3d (N, 17, 3))``: subjects x takes x cameras,
    the cameras of one take of one length (as in Human3.6M).  The take lengths
    are :func:`eval_lengths` in an order drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, 3, 32))
    takes = rng.permutation(eval_lengths(traffic))
    cams = traffic["cameras"]
    lengths = np.repeat(takes, cams)
    gen = generator(seed, 4, device)
    p2 = _split(_walks(gen, device, len(lengths), lengths, 17, 2, 0.4, 0.003), lengths)
    p3 = _split(_walks(gen, device, len(lengths), lengths, 17, 3, 0.5, 0.002), lengths)
    per_action = traffic["subjects"] * traffic["takes"] * cams
    videos = list(zip(p2, p3))
    # Video v belongs to take v // cams; takes are laid out action-major.
    return [videos[a * per_action:(a + 1) * per_action] for a in range(traffic["actions"])]


def stream_tracks(traffic, seed: int, device):
    """(track_frames, streams, 17, 2) float32 host keypoints: each stream a base
    pose plus three sinusoids per coordinate whose periods divide the track, so
    a stream loops over its track without a jump."""
    length, b = traffic["track_frames"], traffic["streams"]
    gen = generator(seed, 5, device)
    shape = (3, b, 17, 2)
    freq = torch.randint(1, 9, shape, generator=gen, device=device).float()
    phase = torch.rand(shape, generator=gen, device=device) * (2 * np.pi)
    amp = torch.rand(shape, generator=gen, device=device) * 0.03
    base = (torch.rand(b, 17, 2, generator=gen, device=device) * 2 - 1) * 0.4
    t = torch.arange(length, device=device, dtype=torch.float32)[:, None, None, None]
    track = base[None].expand(length, b, 17, 2).clone()
    for h in range(3):
        track += amp[h] * torch.sin(t * (2 * np.pi / length) * freq[h] + phase[h])
    return track.cpu().numpy()


def calibration_clips(tracks, traffic):
    """(clips, frames, 17, 2): the first ``calibration_frames`` frames of
    ``calibration_clips`` streams spread evenly over the batch, as the streaming
    CLI picks its calibration clips."""
    n, t = traffic["calibration_clips"], traffic["calibration_frames"]
    b = tracks.shape[1]
    picked = [i * (b - 1) // max(n - 1, 1) for i in range(n)]
    return np.ascontiguousarray(tracks[:t, picked].transpose(1, 0, 2, 3))
