"""The semi-supervised cell's inputs, made from ``--seed``: the trajectory
network's weights, the labeled stream (2D keypoints and camera-space 3D joints)
and the unlabeled stream (2D keypoints, each sequence seen by one of the four
Human3.6M cameras).  The general generators are ``synth.py``'s; nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import synth

# The four Human3.6M cameras' published intrinsics (the dataset's camera
# metadata): centre (px), focal length (px), radial k1 k2 k3, tangential p1 p2,
# and the image's width and height (px).
H36M_INTRINSICS = {
    "54138969": ((512.54150390625, 515.4514770507812), (1145.0494384765625, 1143.7811279296875),
                 (-0.20709891617298126, 0.24777518212795258, -0.0030751503072679043),
                 (-0.0009756988729350269, -0.00142447161488235), 1000, 1002),
    "55011271": ((508.8486328125, 508.0649108886719), (1149.6756591796875, 1147.5916748046875),
                 (-0.1942136287689209, 0.2404085397720337, 0.006819975562393665),
                 (-0.0016190266469493508, -0.0027408944442868233), 1000, 1000),
    "58860488": ((519.8158569335938, 501.40264892578125), (1149.1407470703125, 1148.7989501953125),
                 (-0.2083381861448288, 0.25548800826072693, -0.0024604974314570427),
                 (0.0014843869721516967, -0.0007599993259645998), 1000, 1000),
    "60457274": ((514.9682006835938, 501.88201904296875), (1145.5113525390625, 1144.77392578125),
                 (-0.198384091258049, 0.21832367777824402, -0.008947807364165783),
                 (-0.0005872055771760643, -0.0018133620033040643), 1000, 1002),
}


def normalised_intrinsics(center, focal, radial, tangential, w, h):
    """The (9,) vector ``[f(2), c(2), k(3), p(2)]`` in normalised screen units
    ([0, w] -> [-1, 1], aspect kept), as the dataset loader makes it."""
    c = np.asarray(center) / w * 2 - np.array([1.0, h / w])
    f = np.asarray(focal) / w * 2
    return np.concatenate([f, c, radial, tangential]).astype(np.float32)


CAMERAS = np.stack([normalised_intrinsics(*v) for v in H36M_INTRINSICS.values()])


def trajectory_config(cfg):
    """The trajectory network's configuration: the pose network's with
    ``trajectory_joints_out`` output joints."""
    return {**cfg, "num_joints_out": cfg["trajectory_joints_out"]}


def trajectory_weights(cfg, seed: int, device):
    """The trajectory network's weights, drawn as ``synth.make_weights`` draws
    the pose network's but from their own seed, with the shrink's depth bias in
    [4, 6] m: back-projected points then lie in the unclamped range of the
    projection, where the reconstruction loss and its gradient are live."""
    w = synth.make_weights(trajectory_config(cfg), synth.sub_seed(seed, 21), device)
    gen = synth.generator(seed, 22, device)
    w["shrink.bias"][2] = 4.0 + 2.0 * torch.rand((), generator=gen, device=device)
    return w


def labeled_set(traffic, seed: int, device):
    """(poses_2d, poses_3d) of ``labeled_sequences`` videos: 2D keypoints in
    normalised screen units, and 3D joints as the prepared dataset holds them,
    the root at its camera-space position 3.5-6.5 m from the camera and the
    other joints relative to it."""
    n, t = traffic["labeled_sequences"], traffic["frames_per_sequence"]
    gen = synth.generator(seed, 23, device)
    lengths = [t] * n
    p2 = synth._walks(gen, device, n, lengths, 17, 2, 0.4, 0.003)
    p3 = synth._walks(gen, device, n, lengths, 17, 3, 0.5, 0.002)
    root = synth._walks(gen, device, n, lengths, 1, 3, 1.0, 0.002)
    root[..., 2] = np.clip(root[..., 2] + 5.0, 3.5, 6.5)
    p3[:, :1] = root
    return synth._split(p2, lengths), synth._split(p3, lengths)


def unlabeled_set(traffic, seed: int, device):
    """(poses_2d, cameras) of ``unlabeled_sequences`` videos: 2D keypoints in
    normalised screen units and, for video i, camera i mod 4's intrinsics."""
    n, t = traffic["unlabeled_sequences"], traffic["frames_per_sequence"]
    gen = synth.generator(seed, 24, device)
    lengths = [t] * n
    p2 = synth._walks(gen, device, n, lengths, 17, 2, 0.4, 0.003)
    return synth._split(p2, lengths), [CAMERAS[i % len(CAMERAS)] for i in range(n)]
