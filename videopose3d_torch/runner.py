"""End-to-end entry point of the port: data preparation -> model -> training
with per-epoch evaluation and checkpoints -> action-wise evaluation or a
rendering.

Counterpart of ``videopose3d_tpu/runner.py`` for supervised and
semi-supervised (``-sun``) training, in the strided form or the dilated one
(``--stride > 1``, ``--dense``, ``--disable-optimizations``), ``--evaluate``
(with ``--by-subject``) and ``--render`` (``--viz-export`` / ``--viz-output``),
on Human3.6M, HumanEva (``-d humaneva15``, ``humaneva20``) and the detections
of videos in the wild (``-d custom``): the same printed lines, schedules,
checkpoint payload, protocol reports, exported poses and training curves.
``--profile-dir`` traces the first training epoch with ``torch.profiler`` and
``--metrics-log`` appends one JSON record per epoch; checkpoints are written on
a background thread (``checkpoint.AsyncCheckpointer``).

``--model dstformer`` (no JAX counterpart) runs MotionBERT's DSTformer at its
published sizes in place of the ConvNet: keypoints without a confidence get 1.0,
training takes clips of 243 frames (pad 0, ``-b`` clips a step) through the same
``SupervisedTrainer`` with AdamW, evaluation cuts each video into clips, and a
checkpoint records ``model_kind`` and ``model_config``; a checkpoint of the other
model is refused.

Under ``python -m torch.distributed.run`` every process trains one data-parallel
rank (``parallel/mesh.py``): NCCL on CUDA, gloo on the CPU, the weights
broadcast from rank 0, the per-epoch evaluation's videos shared out among the
ranks, and only rank 0 writing checkpoints; every rank prints the same epoch
lines and runs the final evaluation.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from videopose3d_torch.arguments import parse_args
from videopose3d_torch.checkpoint import (AsyncCheckpointer, is_torch_optimizer_state,
                                          load_any_checkpoint, model_state_dict)
from videopose3d_torch.data.generators import (ChunkedPairSampler, FlatSequenceDataset,
                                               UnchunkedBatcher)
from videopose3d_torch.evaluate import (DeviceEvalSet, Evaluator, evaluate,
                                        evaluate_actionwise, full_float32)
from videopose3d_torch.models.dstformer import DSTformer, DSTformerConfig
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                receptive_field)
from videopose3d_torch.ops.camera import (camera_to_world, image_coordinates,
                                          normalize_screen_coordinates, world_to_camera)
from videopose3d_torch.parallel.mesh import (DataParallel, all_reduce_, broadcast_module,
                                             initialize_distributed, launcher_world_size,
                                             process_info, shard_batch_size)
from videopose3d_torch.profiling import StepTimer, device_trace, log_metrics_jsonl
from videopose3d_torch.train import (SemiSupervisedTrainer, SupervisedTrainer,
                                     TrainLoopConfig, bn_momentum_for_epoch,
                                     make_optimizer, set_learning_rate)
from videopose3d_torch.utils import deterministic_random


def kernel_width_error(args):
    """Why the hand-written kernels this run would launch cannot take its
    ``--channels``, or None; known from the arguments alone, before any data
    loads.  Only CUDA runs launch kernels: ``--train-engine pallas`` training
    runs the train-block kernels and ``--evaluate`` with ``--serving-engine
    fused`` the fused evaluation blocks (both any width; ``int8``'s stage kernels
    take any width too)."""
    if torch.device(args.device).type != "cuda":
        return None
    c = args.channels
    if not args.evaluate and args.train_engine == "pallas":
        from videopose3d_torch.ops.kernels import train_block
        return train_block.channel_limit_error(c)
    if args.evaluate and args.serving_engine == "fused":
        from videopose3d_torch.ops.kernels import temporal_block
        return temporal_block.channel_limit_error(c)
    return None


def resolve_device(name: str) -> torch.device:
    """The torch device the CLI runs on; 'cuda' needs a card, and is the card of
    ``LOCAL_RANK`` under a launcher (the current card otherwise)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              if launcher_world_size() else torch.cuda.current_device())
    return device


def join_process_group(args, device):
    """The run's ``DataParallel`` under a launcher, None otherwise."""
    if args.no_mesh:
        if launcher_world_size() > 1:
            raise SystemExit(f"error: --no-mesh under a launcher of {launcher_world_size()} "
                             "processes would train that many independent copies")
        return None
    if not initialize_distributed(device):
        return None
    dp = DataParallel.from_group()
    info = process_info()
    print("INFO: distributed runtime: process %d/%d, local rank %d, device %s" % (
        info["rank"], info["world_size"], info["local_rank"], device))
    print(f"INFO: Data-parallel over {dp.world_size} processes")
    return dp


def eval_devices(args, device, dp):
    """Local devices to round-robin evaluation videos over (``--eval-devices``;
    0: every local card of a single-process CUDA run, the process's own device
    otherwise), or None for the one device."""
    local = [device]
    if device.type == "cuda" and dp is None:
        local += [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                  if i != device.index]
    n = min(args.eval_devices if args.eval_devices > 0 else len(local), len(local))
    return local[:n] if n > 1 else None


# ---------------------------------------------------------------------------
# Data loading / preparation
# ---------------------------------------------------------------------------


def load_dataset(args):
    """The dataset of ``-d``: ``h36m`` or ``humaneva15`` / ``humaneva20`` from
    ``<data-dir>/data_3d_<dataset>.npz``, or ``custom`` (videos in the wild, no
    3D ground truth) from the 2D archive ``data_2d_custom_<keypoints>.npz``."""
    print("Loading dataset...")
    path = os.path.join(args.data_dir, f"data_3d_{args.dataset}.npz")
    if args.dataset == "h36m":
        from videopose3d_torch.datasets.h36m import Human36mDataset
        return Human36mDataset(path)
    if args.dataset.startswith("humaneva"):
        from videopose3d_torch.datasets.humaneva import HumanEvaDataset
        return HumanEvaDataset(path)
    if args.dataset.startswith("custom"):
        from videopose3d_torch.datasets.custom import CustomDataset
        return CustomDataset(os.path.join(
            args.data_dir, f"data_2d_{args.dataset}_{args.keypoints}.npz"))
    raise KeyError("Invalid dataset")


def prepare_dataset_3d(dataset):
    """World->camera transform + root-relativization, keeping the global
    trajectory in joint 0."""
    print("Preparing data...")
    for subject in dataset.subjects():
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            if "positions" in anim:
                positions_3d = []
                for cam in anim["cameras"]:
                    pos_3d = np.array(world_to_camera(
                        anim["positions"], R=cam["orientation"], t=cam["translation"]))
                    pos_3d[:, 1:] -= pos_3d[:, :1]
                    positions_3d.append(pos_3d)
                anim["positions_3d"] = positions_3d


def _align_detections_with_mocap(dataset, detections):
    """Every mocap (subject, action, camera) needs a detection stream at least
    as long as its mocap stream; surplus detection frames are trimmed in place."""
    for subject in dataset.subjects():
        if subject not in detections:
            raise KeyError(f"no 2D detections for subject {subject}")
        for action, anim in dataset[subject].items():
            if action not in detections[subject]:
                raise KeyError(f"no 2D detections for {subject}/{action}")
            if "positions_3d" not in anim:
                continue
            cams = detections[subject][action]
            if len(cams) != len(anim["positions_3d"]):
                raise ValueError(f"{subject}/{action}: {len(cams)} detection "
                                 f"cameras vs {len(anim['positions_3d'])} "
                                 "mocap cameras")
            for ci, mocap in enumerate(anim["positions_3d"]):
                if len(cams[ci]) < len(mocap):
                    raise ValueError(
                        f"{subject}/{action} cam {ci}: detection stream "
                        f"shorter than mocap ({len(cams[ci])} < {len(mocap)})")
                cams[ci] = cams[ci][:len(mocap)]


def _to_normalized_screen(dataset, detections):
    """Pixel keypoints -> aspect-preserving unit screen coordinates, in place."""
    for subject, actions in detections.items():
        for cams in actions.values():
            for ci, kps in enumerate(cams):
                cam = dataset.cameras()[subject][ci]
                kps[..., :2] = normalize_screen_coordinates(
                    kps[..., :2], w=cam["res_w"], h=cam["res_h"])


def load_2d_detections(args, dataset):
    """Load the 2D keypoint archive, trim to mocap length, normalize."""
    print("Loading 2D detections...")
    archive = np.load(os.path.join(
        args.data_dir, f"data_2d_{args.dataset}_{args.keypoints}.npz"),
        allow_pickle=True)
    keypoints_metadata = archive["metadata"].item()
    kps_left, kps_right = (list(side) for side in
                           keypoints_metadata["keypoints_symmetry"])
    detections = archive["positions_2d"].item()
    _align_detections_with_mocap(dataset, detections)
    _to_normalized_screen(dataset, detections)
    return detections, keypoints_metadata, kps_left, kps_right


def _subsample_sequences(seqs_2d, seqs_3d, step: int, subset: float):
    """Temporal downsampling by ``step``, in place; with ``subset`` < 1 keep one
    deterministic contiguous window per sequence instead (seeded by the
    sequence's length, the reference's reproducible ``--subset`` selection)."""
    if subset < 1:
        for i, seq in enumerate(seqs_2d):
            kept = int(round(len(seq) // step * subset) * step)
            start = deterministic_random(0, len(seq) - kept + 1, str(len(seq)))
            window = slice(start, start + kept, step)
            seqs_2d[i] = seq[window]
            if seqs_3d is not None:
                seqs_3d[i] = seqs_3d[i][window]
    elif step > 1:
        seqs_2d[:] = [s[::step] for s in seqs_2d]
        if seqs_3d is not None:
            seqs_3d[:] = [s[::step] for s in seqs_3d]


def fetch(args, dataset, keypoints, subjects, action_filter=None, subset=1,
          parse_3d_poses=True):
    """Per-(subject, action, camera) sequences: (intrinsics | None,
    poses_3d | None, poses_2d), one list entry per camera view, downsampled by
    ``--downsample`` and cut to ``subset``; no 3D poses without
    ``parse_3d_poses`` (the unlabeled split)."""
    seqs_2d, seqs_3d, intrinsics = [], [], []
    for subject in subjects:
        for action, kp_cams in keypoints[subject].items():
            if action_filter is not None and not any(
                    action.startswith(a) for a in action_filter):
                continue
            seqs_2d.extend(kp_cams)
            subject_cams = dataset.cameras().get(subject)
            if subject_cams is not None:
                if len(subject_cams) != len(kp_cams):
                    raise ValueError(f"{subject}/{action}: camera count "
                                     "mismatch vs detections")
                intrinsics.extend(c["intrinsic"] for c in subject_cams
                                  if "intrinsic" in c)
            if parse_3d_poses and "positions_3d" in dataset[subject][action]:
                gt_cams = dataset[subject][action]["positions_3d"]
                if len(gt_cams) != len(kp_cams):
                    raise ValueError(f"{subject}/{action}: camera count "
                                     "mismatch vs mocap")
                seqs_3d.extend(gt_cams)

    seqs_3d = seqs_3d or None
    _subsample_sequences(seqs_2d, seqs_3d, args.downsample, subset)
    return (intrinsics or None), seqs_3d, seqs_2d


def _flip_perm_from_lists(num, left, right):
    perm = np.arange(num)
    perm[list(left)] = list(right)
    perm[list(right)] = list(left)
    return perm


def _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm, cameras,
                  poses_3d, poses_2d, *, augment=False):
    return UnchunkedBatcher(
        cameras, poses_3d, poses_2d, pad=pad, causal_shift=causal_shift,
        augment=augment, kps_flip_perm=kps_perm, joints_flip_perm=joints_perm,
        bucket=args.eval_bucket, bucket_pow2=args.eval_bucket_pow2)


def _dstformer_config(num_kps: int, num_joints: int) -> DSTformerConfig:
    """The published DSTformer for ``num_kps`` keypoints in, the same joints out."""
    if num_kps != num_joints:
        raise SystemExit(f"error: the DSTformer lifts each keypoint to its joint: {num_kps} "
                         f"keypoints for {num_joints} joints")
    return DSTformerConfig(num_joints=num_kps)


def _with_confidence(keypoints) -> None:
    """Append a confidence of 1.0 to every keypoint of a dataset without scores
    (MotionBERT's input for ground-truth 2D), in place."""
    for actions in keypoints.values():
        for cams in actions.values():
            for i, kps in enumerate(cams):
                if kps.shape[-1] == 2:
                    cams[i] = np.concatenate([kps, np.ones_like(kps[..., :1])], axis=-1)


def load_model(model: TemporalModel, model_pos) -> None:
    """Load a reference-layout state dict (numpy or torch values) strictly."""
    device = next(model.parameters()).device
    model.load_state_dict({k: torch.from_numpy(np.array(v)).to(device)
                           for k, v in model_pos.items()}, strict=True)


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def main(argv=None):
    args = parse_args(argv)
    print(args)
    refused = kernel_width_error(args)
    if refused:
        raise SystemExit(f"error: {refused}")
    device = resolve_device(args.device)
    dp = join_process_group(args, device)
    if dp is not None and args.model == "dstformer":
        raise SystemExit("error: --model dstformer trains on one process, not "
                         f"{dp.world_size} data-parallel ones")
    os.makedirs(args.checkpoint, exist_ok=True)

    dataset = load_dataset(args)
    prepare_dataset_3d(dataset)
    keypoints, keypoints_metadata, kps_left, kps_right = load_2d_detections(args, dataset)
    joints_left = list(dataset.skeleton().joints_left())
    joints_right = list(dataset.skeleton().joints_right())

    subjects_train = args.subjects_train.split(",")
    subjects_semi = args.subjects_unlabeled.split(",") if args.subjects_unlabeled else []
    subjects_test = [args.viz_subject] if args.render else args.subjects_test.split(",")
    if subjects_semi and not dataset.supports_semi_supervised():
        raise RuntimeError("Semi-supervised training is not implemented for this dataset")
    action_filter = None if args.actions == "*" else args.actions.split(",")
    if action_filter is not None:
        print("Selected actions:", action_filter)

    if args.model == "dstformer":
        _with_confidence(keypoints)
    cameras_valid, poses_valid, poses_valid_2d = fetch(
        args, dataset, keypoints, subjects_test, action_filter)

    num_kps = poses_valid_2d[0].shape[-2]
    if args.model == "dstformer":
        model_cfg = _dstformer_config(num_kps, dataset.skeleton().num_joints())
        use_strided, pad, causal_shift = False, 0, 0
        # It computes whole clips: the evaluated videos are bucketed to them.
        args.eval_bucket, args.eval_bucket_pow2 = model_cfg.maxlen, False
        print(f"INFO: DSTformer on clips of {model_cfg.maxlen} frames")
        torch.manual_seed(args.seed)
        model = DSTformer(model_cfg).to(device)
    else:
        filter_widths = tuple(int(x) for x in args.architecture.split(","))
        use_strided = (not args.disable_optimizations and not args.dense
                       and args.stride == 1)
        model_cfg = TemporalModelConfig(
            num_joints_in=num_kps, in_features=poses_valid_2d[0].shape[-1],
            num_joints_out=dataset.skeleton().num_joints(),
            filter_widths=filter_widths, causal=args.causal, dropout=args.dropout,
            channels=args.channels, dense=args.dense, compute_dtype=args.compute_dtype,
            train_engine=args.train_engine)
        # The trajectory model: one output joint, and the pose model's train engine
        # (its residual blocks have the pose model's shapes; the JAX package gives it
        # the plain blocks).
        traj_cfg = dataclasses.replace(model_cfg, num_joints_out=1)

        rf = receptive_field(model_cfg)
        print(f"INFO: Receptive field: {rf} frames")
        pad = (rf - 1) // 2
        if args.causal:
            print("INFO: Using causal convolutions")
            causal_shift = pad
        else:
            causal_shift = 0

        torch.manual_seed(args.seed)
        model = TemporalModel(model_cfg).to(device)
    print("INFO: Trainable parameter count:",
          sum(p.numel() for p in model.parameters()))

    kps_perm = _flip_perm_from_lists(num_kps, kps_left, kps_right)
    joints_perm = _flip_perm_from_lists(
        dataset.skeleton().num_joints(), joints_left, joints_right)

    checkpoint = None
    traj_model = None
    if args.resume or args.evaluate:
        chk_filename = os.path.join(args.checkpoint, args.resume or args.evaluate)
        print("Loading checkpoint", chk_filename)
        checkpoint = load_any_checkpoint(chk_filename)
        kind = checkpoint.get("model_kind", "tcn")
        if kind != model.kind:
            raise SystemExit(f"error: {chk_filename} holds a {kind} model, not the "
                             f"{model.kind} that --model {args.model} builds")
        print("This model was trained for {} epochs".format(checkpoint["epoch"]))
        load_model(model, checkpoint["model_pos"])
        if args.evaluate and args.render and checkpoint.get("model_traj") is not None:
            # A rendering of an unlabeled video adds the predicted trajectory.
            traj_model = TemporalModel(traj_cfg).to(device)
            load_model(traj_model, checkpoint["model_traj"])

    test_batcher = _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm,
                                 cameras_valid, poses_valid, poses_valid_2d)
    print("INFO: Testing on {} frames".format(test_batcher.num_frames()))

    # Per-epoch evaluation during training stays metric grade; the serving
    # engine applies to --evaluate runs.
    engine = args.serving_engine if args.evaluate else "xla"
    evaluator = Evaluator(model_cfg, joints_flip_perm=joints_perm, engine=engine,
                          device=device)
    devices = eval_devices(args, device, dp)

    if not args.evaluate:
        if subjects_semi:
            traj_model = TemporalModel(traj_cfg).to(device)
        _train(args, dataset, keypoints, subjects_train, subjects_semi, action_filter,
               model, traj_model, use_strided, kps_perm, joints_perm, pad, causal_shift,
               evaluator, test_batcher, checkpoint, device, dp, devices)

    model.eval()
    if args.render:
        _render(args, dataset, keypoints, keypoints_metadata, model, traj_model, evaluator,
                pad, causal_shift, kps_perm, joints_perm, device)
        return
    print("Evaluating...")
    start = time.perf_counter()
    n_frames = _final_evaluation(args, dataset, keypoints, subjects_test,
                                 action_filter, model, evaluator, pad, causal_shift,
                                 kps_perm, joints_perm, devices)
    seconds = time.perf_counter() - start
    print(f"INFO: evaluated {n_frames} frames in {seconds:.3f} s "
          f"({n_frames / seconds:.1f} frames/s, engine {engine}, device {device})")


def _train(args, dataset, keypoints, subjects_train, subjects_semi, action_filter,
           model, traj_model, use_strided, kps_perm, joints_perm, pad, causal_shift,
           evaluator, test_batcher, checkpoint, device, dp, devices):
    """The training loop: epochs of train steps (semi-supervised with a
    trajectory model), the per-epoch evaluation and epoch line, the lr and
    BatchNorm-momentum schedules, and checkpoints every
    ``--checkpoint-frequency`` epochs; data-parallel under ``dp``."""
    semi = traj_model is not None
    cameras_train, poses_train, poses_train_2d = fetch(
        args, dataset, keypoints, subjects_train, action_filter, subset=args.subset)

    lr = args.learning_rate
    dst = args.model == "dstformer"
    loop_cfg = TrainLoopConfig(
        batch_size=args.batch_size if dst else args.batch_size // args.stride,
        chunk_length=model.config.maxlen if dst else args.stride, pad=pad,
        causal_shift=causal_shift, learning_rate=lr, lr_decay=args.lr_decay,
        epochs=args.epochs, use_strided=use_strided, warmup=args.warmup,
        bone_length_term=args.bone_length_term, no_proj=args.no_proj,
        linear_projection=args.linear_projection, gather_impl=args.gather_impl)
    if dp is not None and loop_cfg.batch_size % dp.world_size:
        new_bs = shard_batch_size(loop_cfg.batch_size, dp.world_size)
        print(f"INFO: rounding batch size {loop_cfg.batch_size} -> {new_bs} "
              f"to divide across {dp.world_size} processes")
        loop_cfg = dataclasses.replace(loop_cfg, batch_size=new_bs)
    flip_perms = (kps_perm, joints_perm) if args.data_augmentation else None
    margins = FlatSequenceDataset.training_margins(pad, causal_shift, loop_cfg.chunk_length)
    dev = FlatSequenceDataset(poses_train_2d, poses_train, cameras_train, margins=margins,
                              flip_perms=flip_perms).to_device(device)
    sampler = ChunkedPairSampler(
        [p.shape[0] for p in poses_train_2d], loop_cfg.batch_size,
        loop_cfg.chunk_length, augment=args.data_augmentation)
    train_eval_batcher = _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm,
                                       cameras_train, poses_train, poses_train_2d)
    print("INFO: Training on {} frames".format(train_eval_batcher.num_frames()))

    if semi:
        cameras_semi, _, poses_semi_2d = fetch(args, dataset, keypoints, subjects_semi,
                                               action_filter, parse_3d_poses=False)
        dev_semi = FlatSequenceDataset(poses_semi_2d, None, cameras_semi, margins=margins,
                                       flip_perms=flip_perms).to_device(device)
        sampler_semi = ChunkedPairSampler(
            [p.shape[0] for p in poses_semi_2d], loop_cfg.batch_size,
            loop_cfg.chunk_length, random_seed=4321, augment=args.data_augmentation,
            endless=True)
        semi_eval_batcher = _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm,
                                          cameras_semi, None, poses_semi_2d)
        print("INFO: Semi-supervision on {} frames".format(
            semi_eval_batcher.num_frames()))
        optimizer = make_optimizer([model, traj_model], lr)
        trainer = SemiSupervisedTrainer(model, traj_model, loop_cfg, optimizer,
                                        dataset.skeleton().parents(), dp=dp)
    else:
        optimizer = make_optimizer(model, lr)
        trainer = SupervisedTrainer(model, loop_cfg, optimizer, dp=dp)
    # Dropout masks: one generator on the model's device, seeded from --seed.
    generator = torch.Generator(device=device).manual_seed(args.seed)

    epoch = 0
    if args.resume and checkpoint is not None:
        epoch = int(checkpoint["epoch"])
        lr = float(checkpoint["lr"])
        # A JAX CLI checkpoint's optax state (opaque here) restarts the optimizer
        # and the sampler's RNG, as the JAX CLI does with the port's torch state.
        if is_torch_optimizer_state(checkpoint.get("optimizer")):
            optimizer.load_state_dict(checkpoint["optimizer"])
            sampler.set_random_state(checkpoint["random_state"])
        else:
            print("WARNING: this checkpoint does not contain an optimizer state. "
                  "The optimizer will be reinitialized.")
        if semi:
            load_model(traj_model, checkpoint["model_traj"])
            if checkpoint.get("random_state_semi") is not None:
                sampler_semi.set_random_state(checkpoint["random_state_semi"])
            if checkpoint.get("stream_rng_semi") is not None:
                # The unlabeled stream goes on inside its permutation.
                sampler_semi.set_stream_state((int(checkpoint["stream_idx_semi"]),
                                               checkpoint["stream_rng_semi"]))
        step_rng = checkpoint.get("step_rng")
        if isinstance(step_rng, torch.Tensor) and step_rng.dtype == torch.uint8:
            generator.set_state(step_rng)
        set_learning_rate(optimizer, lr)
    if dp is not None:
        broadcast_module(model, group=dp.group)
        broadcast_module(traj_model, group=dp.group)

    # The dilated form runs no train-block kernel, whatever --train-engine says
    # (as in the JAX package); the lines below name the form that ran.
    form = (f"engine {args.train_engine}" if use_strided or dst
            else "dilated form")
    if dst:
        print(f"INFO: Training the DSTformer on clips of {loop_cfg.chunk_length} frames "
              f"({loop_cfg.batch_size} a step, AdamW)")
    elif not use_strided:
        print(f"INFO: Training the dilated form on chunks of {loop_cfg.chunk_length} "
              "frames (plain blocks)")
    print("** Note: reported losses are averaged over all frames and test-time "
          "augmentation is not used here.")
    print("** The final evaluation will be carried out after the last training "
          "epoch.")

    eval_sets = None
    if not args.no_eval:
        # The videos go round-robin over the ranks, and within a rank over its
        # evaluation devices.
        shard = None if dp is None else (dp.rank, dp.world_size)
        eval_sets = {name: DeviceEvalSet(b, pad=pad, device=device, with_traj=semi,
                                         shard=shard, devices=devices)
                     for name, b in (("test", test_batcher), ("train", train_eval_batcher))}
        if semi:
            eval_sets["semi"] = DeviceEvalSet(semi_eval_batcher, pad=pad, device=device,
                                              with_traj=True, shard=shard, devices=devices)
        # Trajectory inference stays on the plain float32 engine.
        traj_evaluator = (Evaluator(traj_model.config, engine="xla", device=device)
                          if semi else None)
    semi_iter = sampler_semi.next_epoch() if semi else None
    losses_3d_train, losses_3d_train_eval, losses_3d_valid = [], [], []
    losses_traj_train, losses_traj_train_eval, losses_traj_valid = [], [], []
    losses_2d_train_unlabeled, losses_2d_train_labeled_eval = [], []
    losses_2d_train_unlabeled_eval, losses_2d_valid = [], []
    train_seconds, train_steps, train_frames = 0.0, 0, 0
    writer = dp is None or dp.rank == 0  # the rank that writes files
    step_timer = StepTimer()
    first_epoch = epoch
    checkpointer = AsyncCheckpointer()

    while epoch < args.epochs:
        start_time = time.time()
        momentum = bn_momentum_for_epoch(loop_cfg, epoch - 1)
        skip = epoch < loop_cfg.warmup
        losses, n_valids, n_valids_semi = [], [], []
        trace_dir = args.profile_dir if epoch == first_epoch else None
        if trace_dir is not None and dp is not None:
            trace_dir = os.path.join(trace_dir, f"rank{dp.rank}")
        step_timer.reset()
        step_timer.start()
        step_start = time.perf_counter()
        with device_trace(trace_dir, device), full_float32():
            for meta, n_valid in sampler.next_epoch():
                if semi:
                    # One unlabeled batch per step, in warmup too: the stream
                    # advances as the JAX CLI's does.
                    meta_semi, n_valid_semi = next(semi_iter)
                    losses.append(torch.stack(trainer.step(
                        dev, dev_semi, meta, n_valid, meta_semi, n_valid_semi, momentum,
                        skip, generator)[:3]))
                    n_valids_semi.append(n_valid_semi)
                else:
                    losses.append(trainer.step(dev, meta, n_valid, momentum, generator))
                n_valids.append(n_valid)
                step_timer.tick()
        vals = torch.stack(losses)
        if dp is not None:  # each rank's losses are its shares
            all_reduce_(vals, dp.group)
        vals = vals.double().cpu().numpy()  # waits for the steps
        train_seconds += time.perf_counter() - step_start
        train_steps += len(losses)
        train_frames += sum(n_valids) * loop_cfg.chunk_length
        weights = np.asarray(n_valids, np.float64)
        if semi:  # (pose, trajectory, 2D reconstruction) per step
            weights_semi = np.asarray(n_valids_semi, np.float64)
            losses_traj_train.append(float(np.sum(vals[:, 1] * weights) / np.sum(weights)))
            losses_2d_train_unlabeled.append(
                float(np.sum(vals[:, 2] * weights_semi) / np.sum(weights_semi)))
            vals = vals[:, 0]
        losses_3d_train.append(float(np.sum(vals * weights) / np.sum(weights)))
        if args.metrics_log and writer:
            log_metrics_jsonl(args.metrics_log, {
                "epoch": epoch + 1,
                "lr": lr,
                "bn_momentum": momentum,
                "loss_3d_train": losses_3d_train[-1],
                **{f"step_{k}": v for k, v in step_timer.summary().items()},
            })

        if not args.no_eval:
            if semi:
                te, tr, se = (eval_sets[k].losses(evaluator, model, traj_evaluator,
                                                  traj_model)
                              for k in ("test", "train", "semi"))
                losses_traj_valid.append(te[1])
                losses_2d_valid.append(te[2])
                losses_traj_train_eval.append(tr[1])
                losses_2d_train_labeled_eval.append(tr[2])
                losses_2d_train_unlabeled_eval.append(se[2])
            else:
                te, tr = ((eval_sets[k].loss(evaluator, model),) for k in ("test", "train"))
            losses_3d_valid.append(te[0])
            losses_3d_train_eval.append(tr[0])

        elapsed = (time.time() - start_time) / 60
        if args.no_eval:
            print("[%d] time %.2f lr %f 3d_train %f" % (
                epoch + 1, elapsed, lr, losses_3d_train[-1] * 1000))
        elif semi:
            print("[%d] time %.2f lr %f 3d_train %f 3d_eval %f traj_eval %f "
                  "3d_valid %f traj_valid %f 2d_train_sup %f 2d_train_unsup %f "
                  "2d_valid %f" % (
                      epoch + 1, elapsed, lr, losses_3d_train[-1] * 1000,
                      tr[0] * 1000, tr[1] * 1000, te[0] * 1000, te[1] * 1000, tr[2],
                      se[2], te[2]))
        else:
            print("[%d] time %.2f lr %f 3d_train %f 3d_eval %f 3d_valid %f" % (
                epoch + 1, elapsed, lr, losses_3d_train[-1] * 1000,
                tr[0] * 1000, te[0] * 1000))

        lr *= args.lr_decay
        set_learning_rate(optimizer, lr)
        epoch += 1

        if epoch % args.checkpoint_frequency == 0 and writer:
            chk_path = os.path.join(args.checkpoint, f"epoch_{epoch}.bin")
            print("Saving checkpoint to", chk_path)
            stream_semi = sampler_semi.stream_state() if semi else None
            # The live tensors: the checkpointer clones them before the next
            # step writes them in place, and copies them to the host off the
            # step path.
            checkpointer.save(chk_path, {
                "epoch": epoch,
                "lr": lr,
                "random_state": sampler.random_state(),
                "optimizer": optimizer.state_dict(),
                "model_pos": model_state_dict(model, copy=False),
                "model_traj": model_state_dict(traj_model, copy=False) if semi else None,
                "random_state_semi": sampler_semi.random_state() if semi else None,
                # The unlabeled stream's place inside its permutation, so that a
                # resume goes on with the same batches.
                "stream_idx_semi": None if stream_semi is None else stream_semi[0],
                "stream_rng_semi": None if stream_semi is None else stream_semi[1],
                # The dropout generator's state: a resume replays the masks.
                "step_rng": generator.get_state(),
                # Which model the weights are of (absent: the ConvNet).
                **({"model_kind": model.kind,
                    "model_config": dataclasses.asdict(model.config)} if dst else {}),
            })

        if args.export_training_curves and epoch > 3 and writer:
            _export_training_curves(
                args, epoch, semi, losses_3d_train, losses_3d_train_eval, losses_3d_valid,
                losses_traj_train, losses_traj_train_eval, losses_traj_valid,
                losses_2d_train_labeled_eval, losses_2d_train_unlabeled,
                losses_2d_train_unlabeled_eval, losses_2d_valid)

    checkpointer.wait()  # the last save is on disk before evaluation or exit
    print(f"INFO: trained {train_steps} steps in {train_seconds:.3f} s "
          f"({train_frames / max(train_seconds, 1e-9):.1f} frames/s, {form}, "
          f"device {device})")


def _export_training_curves(args, epoch, semi_supervised, losses_3d_train,
                            losses_3d_train_eval, losses_3d_valid, losses_traj_train,
                            losses_traj_train_eval, losses_traj_valid,
                            losses_2d_train_labeled_eval, losses_2d_train_unlabeled,
                            losses_2d_train_unlabeled_eval, losses_2d_valid):
    """The loss curves from epoch 4 on as PNGs in the checkpoint directory:
    ``loss_3d.png``, and under semi-supervision ``loss_traj.png`` and
    ``loss_2d.png`` (the JAX package's figures)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    epoch_x = np.arange(3, len(losses_3d_train)) + 1
    plt.plot(epoch_x, losses_3d_train[3:], "--", color="C0")
    plt.plot(epoch_x, losses_3d_train_eval[3:], color="C0")
    plt.plot(epoch_x, losses_3d_valid[3:], color="C1")
    plt.legend(["3d train", "3d train (eval)", "3d valid (eval)"])
    plt.ylabel("MPJPE (m)")
    plt.xlabel("Epoch")
    plt.xlim((3, epoch))
    plt.savefig(os.path.join(args.checkpoint, "loss_3d.png"))

    if semi_supervised:
        plt.figure()
        plt.plot(epoch_x, losses_traj_train[3:], "--", color="C0")
        plt.plot(epoch_x, losses_traj_train_eval[3:], color="C0")
        plt.plot(epoch_x, losses_traj_valid[3:], color="C1")
        plt.legend(["traj. train", "traj. train (eval)", "traj. valid (eval)"])
        plt.ylabel("Mean distance (m)")
        plt.xlabel("Epoch")
        plt.xlim((3, epoch))
        plt.savefig(os.path.join(args.checkpoint, "loss_traj.png"))

        plt.figure()
        plt.plot(epoch_x, losses_2d_train_labeled_eval[3:], color="C0")
        plt.plot(epoch_x, losses_2d_train_unlabeled[3:], "--", color="C1")
        plt.plot(epoch_x, losses_2d_train_unlabeled_eval[3:], color="C1")
        plt.plot(epoch_x, losses_2d_valid[3:], color="C2")
        plt.legend(["2d train labeled (eval)", "2d train unlabeled",
                    "2d train unlabeled (eval)", "2d valid (eval)"])
        plt.ylabel("MPJPE (2D)")
        plt.xlabel("Epoch")
        plt.xlim((3, epoch))
        plt.savefig(os.path.join(args.checkpoint, "loss_2d.png"))
    plt.close("all")


def _final_evaluation(args, dataset, keypoints, subjects_test, action_filter,
                      model, evaluator, pad, causal_shift, kps_perm, joints_perm,
                      devices=None):
    """Action-wise protocols (per subject with ``--by-subject``), the videos
    round-robin over ``devices``; returns the number of frames evaluated."""
    all_actions = {}
    all_actions_by_subject = {}
    for subject in subjects_test:
        all_actions_by_subject.setdefault(subject, {})
        for action in dataset[subject].keys():
            action_name = action.split(" ")[0]
            all_actions.setdefault(action_name, [])
            all_actions_by_subject[subject].setdefault(action_name, [])
            all_actions[action_name].append((subject, action))
            all_actions_by_subject[subject][action_name].append((subject, action))

    n_frames = 0

    def fetch_actions(pairs):
        seqs_2d, seqs_3d = [], []
        for subject, action in pairs:
            kp_cams = keypoints[subject][action]
            gt_cams = dataset[subject][action]["positions_3d"]
            if len(kp_cams) != len(gt_cams):
                raise ValueError(f"{subject}/{action}: camera count mismatch")
            seqs_2d.extend(kp_cams)
            seqs_3d.extend(gt_cams)
        _subsample_sequences(seqs_2d, seqs_3d, args.downsample, 1)
        return seqs_3d, seqs_2d

    def make_batcher(action_pairs):
        nonlocal n_frames
        poses_act, poses_2d_act = fetch_actions(action_pairs)
        batcher = _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm,
                                None, poses_act, poses_2d_act,
                                augment=args.test_time_augmentation)
        n_frames += batcher.num_frames()
        return batcher

    if not args.by_subject:
        evaluate_actionwise(evaluator, model, all_actions, make_batcher,
                            action_filter=action_filter, devices=devices)
    else:
        for subject in all_actions_by_subject.keys():
            print("Evaluating on subject", subject)
            evaluate_actionwise(evaluator, model, all_actions_by_subject[subject],
                                make_batcher, action_filter=action_filter,
                                devices=devices)
            print("")
    return n_frames


def _render(args, dataset, keypoints, keypoints_metadata, model, traj_model, evaluator,
            pad, causal_shift, kps_perm, joints_perm, device):
    """One video (``--viz-subject`` / ``--viz-action`` / ``--viz-camera``)
    through the evaluator: ``--viz-export`` saves the camera-space prediction
    (plus the trajectory model's, for an unlabeled video when there is one);
    ``--viz-output`` renders it in world space beside the input keypoints and
    the ground truth, where the action has it."""
    print("Rendering...")
    input_keypoints = keypoints[args.viz_subject][args.viz_action][args.viz_camera].copy()
    ground_truth = None
    if (args.viz_subject in dataset.subjects()
            and args.viz_action in dataset[args.viz_subject]):
        if "positions_3d" in dataset[args.viz_subject][args.viz_action]:
            ground_truth = dataset[args.viz_subject][args.viz_action][
                "positions_3d"][args.viz_camera].copy()
    if ground_truth is None:
        print("INFO: this action is unlabeled. Ground truth will not be rendered.")

    batcher = _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm,
                            None, None, [input_keypoints],
                            augment=args.test_time_augmentation)
    prediction = evaluate(evaluator, model, batcher, return_predictions=True)
    if traj_model is not None and ground_truth is None:
        traj_evaluator = Evaluator(traj_model.config, engine="xla", device=device)
        prediction = prediction + evaluate(traj_evaluator, traj_model, batcher,
                                           return_predictions=True)

    if args.viz_export is not None:
        print("Exporting joint positions to", args.viz_export)
        np.save(args.viz_export, prediction)  # camera space

    if args.viz_output is not None:
        if ground_truth is not None:
            trajectory = ground_truth[:, :1]
            ground_truth[:, 1:] += trajectory
            prediction = prediction + trajectory

        cam = dataset.cameras()[args.viz_subject][args.viz_camera]
        if ground_truth is not None:
            prediction = camera_to_world(prediction, R=cam["orientation"],
                                         t=cam["translation"])
            ground_truth = camera_to_world(ground_truth, R=cam["orientation"],
                                           t=cam["translation"])
        else:
            # A wild video has no extrinsics: borrow any subject's (for the
            # view only) and put the lowest joint on the floor.
            rot = None
            for subject in dataset.cameras():
                if "orientation" in dataset.cameras()[subject][args.viz_camera]:
                    rot = dataset.cameras()[subject][args.viz_camera]["orientation"]
                    break
            prediction = camera_to_world(prediction, R=rot, t=0)
            prediction[:, :, 2] -= np.min(prediction[:, :, 2])

        anim_output = {"Reconstruction": prediction}
        if ground_truth is not None and not args.viz_no_ground_truth:
            anim_output["Ground truth"] = ground_truth

        input_keypoints = image_coordinates(input_keypoints[..., :2], w=cam["res_w"],
                                            h=cam["res_h"])

        from videopose3d_torch.visualization import render_animation
        render_animation(
            input_keypoints, keypoints_metadata, anim_output,
            dataset.skeleton(), dataset.fps(), args.viz_bitrate, cam["azimuth"],
            args.viz_output, limit=args.viz_limit,
            downsample=args.viz_downsample, size=args.viz_size,
            input_video_path=args.viz_video,
            viewport=(cam["res_w"], cam["res_h"]),
            input_video_skip=args.viz_skip)


if __name__ == "__main__":
    main()
