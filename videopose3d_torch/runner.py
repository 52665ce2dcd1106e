"""End-to-end entry point of the port: data preparation -> model -> supervised
training with per-epoch evaluation and checkpoints -> action-wise evaluation.

Counterpart of ``videopose3d_tpu/runner.py`` for supervised training and
``--evaluate`` (with ``--by-subject``): the same printed lines, schedules,
checkpoint payload and protocol reports.  Semi-supervised training (``-sun``),
``--render`` and ``--export-training-curves`` are not ported yet and raise.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from videopose3d_torch.arguments import parse_args
from videopose3d_torch.checkpoint import (is_torch_optimizer_state, load_any_checkpoint,
                                          model_state_dict, save_checkpoint)
from videopose3d_torch.data.generators import (ChunkedPairSampler, FlatSequenceDataset,
                                               UnchunkedBatcher)
from videopose3d_torch.evaluate import (DeviceEvalSet, Evaluator, evaluate_actionwise,
                                        full_float32)
from videopose3d_torch.models.temporal import (TemporalModel, TemporalModelConfig,
                                                receptive_field)
from videopose3d_torch.ops.camera import normalize_screen_coordinates, world_to_camera
from videopose3d_torch.train import (SupervisedTrainer, TrainLoopConfig,
                                     bn_momentum_for_epoch, make_optimizer,
                                     set_learning_rate)
from videopose3d_torch.utils import deterministic_random

_NOT_PORTED = ("is not ported to videopose3d_torch yet (see ROADMAP.md, Queue 1); "
               "run it with the JAX package (python run.py)")


# The fused evaluation kernels' expand block reads the 2D keypoints of the one
# dataset the port loads, Human3.6M: 17 joints of (x, y).
_H36M_INPUT_COLUMNS = 17 * 2


def kernel_width_error(args):
    """Why the hand-written kernels this run would launch cannot take its
    ``--channels``, or None; known from the arguments alone, before any data
    loads.  Only CUDA runs launch kernels: ``--train-engine pallas`` training
    runs the train-block kernels, ``--evaluate`` with ``--serving-engine fused``
    the fused evaluation blocks."""
    if torch.device(args.device).type != "cuda":
        return None
    c = args.channels
    if not args.evaluate and args.train_engine == "pallas":
        from videopose3d_torch.ops.kernels import train_block
        return train_block.channel_limit_error(c)
    widths = [int(x) for x in args.architecture.split(",")]
    if args.evaluate and args.serving_engine == "fused" and len(widths) > 1:
        from videopose3d_torch.ops.kernels import temporal_block
        return temporal_block.channel_limit_error(
            c, c_in=_H36M_INPUT_COLUMNS, k0=widths[0], span=(widths[1] - 1) * widths[0])
    return None


def resolve_device(name: str) -> torch.device:
    """The torch device the CLI runs on; 'cuda' needs a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


# ---------------------------------------------------------------------------
# Data loading / preparation
# ---------------------------------------------------------------------------


def load_dataset(args):
    print("Loading dataset...")
    if args.dataset != "h36m":
        raise NotImplementedError(f"dataset {args.dataset!r} {_NOT_PORTED}")
    from videopose3d_torch.datasets.h36m import Human36mDataset
    return Human36mDataset(os.path.join(args.data_dir, "data_3d_h36m.npz"))


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


def fetch(args, dataset, keypoints, subjects, action_filter=None, subset=1):
    """Per-(subject, action, camera) sequences: (intrinsics | None,
    poses_3d | None, poses_2d), one list entry per camera view, downsampled by
    ``--downsample`` and cut to ``subset``."""
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
            if "positions_3d" in dataset[subject][action]:
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
    if args.subjects_unlabeled:
        raise NotImplementedError(f"semi-supervised training (-sun) {_NOT_PORTED}")
    if args.render:
        raise NotImplementedError(f"--render {_NOT_PORTED}")
    if args.export_training_curves:
        raise NotImplementedError(f"--export-training-curves {_NOT_PORTED}")
    refused = kernel_width_error(args)
    if refused:
        raise SystemExit(f"error: {refused}")
    device = resolve_device(args.device)
    os.makedirs(args.checkpoint, exist_ok=True)

    dataset = load_dataset(args)
    prepare_dataset_3d(dataset)
    keypoints, _, kps_left, kps_right = load_2d_detections(args, dataset)
    joints_left = list(dataset.skeleton().joints_left())
    joints_right = list(dataset.skeleton().joints_right())

    subjects_train = args.subjects_train.split(",")
    subjects_test = args.subjects_test.split(",")
    action_filter = None if args.actions == "*" else args.actions.split(",")
    if action_filter is not None:
        print("Selected actions:", action_filter)

    cameras_valid, poses_valid, poses_valid_2d = fetch(
        args, dataset, keypoints, subjects_test, action_filter)

    filter_widths = tuple(int(x) for x in args.architecture.split(","))
    num_kps = poses_valid_2d[0].shape[-2]
    use_strided = (not args.disable_optimizations and not args.dense
                   and args.stride == 1)
    model_cfg = TemporalModelConfig(
        num_joints_in=num_kps, in_features=poses_valid_2d[0].shape[-1],
        num_joints_out=dataset.skeleton().num_joints(),
        filter_widths=filter_widths, causal=args.causal, dropout=args.dropout,
        channels=args.channels, dense=args.dense, compute_dtype=args.compute_dtype,
        train_engine=args.train_engine)

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
    if args.resume or args.evaluate:
        chk_filename = os.path.join(args.checkpoint, args.resume or args.evaluate)
        print("Loading checkpoint", chk_filename)
        checkpoint = load_any_checkpoint(chk_filename)
        print("This model was trained for {} epochs".format(checkpoint["epoch"]))
        load_model(model, checkpoint["model_pos"])

    test_batcher = _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm,
                                 cameras_valid, poses_valid, poses_valid_2d)
    print("INFO: Testing on {} frames".format(test_batcher.num_frames()))

    # Per-epoch evaluation during training stays metric grade; the serving
    # engine applies to --evaluate runs.
    engine = args.serving_engine if args.evaluate else "xla"
    evaluator = Evaluator(model_cfg, joints_flip_perm=joints_perm, engine=engine,
                          device=device)

    if not args.evaluate:
        _train(args, dataset, keypoints, subjects_train, action_filter, model,
               use_strided, kps_perm, joints_perm, pad, causal_shift, evaluator,
               test_batcher, checkpoint, device)

    model.eval()
    print("Evaluating...")
    start = time.perf_counter()
    n_frames = _final_evaluation(args, dataset, keypoints, subjects_test,
                                 action_filter, model, evaluator, pad, causal_shift,
                                 kps_perm, joints_perm)
    seconds = time.perf_counter() - start
    print(f"INFO: evaluated {n_frames} frames in {seconds:.3f} s "
          f"({n_frames / seconds:.1f} frames/s, engine {engine}, device {device})")


def _train(args, dataset, keypoints, subjects_train, action_filter, model,
           use_strided, kps_perm, joints_perm, pad, causal_shift, evaluator,
           test_batcher, checkpoint, device):
    """The supervised training loop: epochs of train steps, the per-epoch
    evaluation and epoch line, the lr and BatchNorm-momentum schedules, and
    checkpoints every ``--checkpoint-frequency`` epochs."""
    cameras_train, poses_train, poses_train_2d = fetch(
        args, dataset, keypoints, subjects_train, action_filter, subset=args.subset)

    lr = args.learning_rate
    loop_cfg = TrainLoopConfig(
        batch_size=args.batch_size // args.stride, chunk_length=args.stride, pad=pad,
        causal_shift=causal_shift, learning_rate=lr, lr_decay=args.lr_decay,
        epochs=args.epochs, use_strided=use_strided, gather_impl=args.gather_impl)
    flip_perms = (kps_perm, joints_perm) if args.data_augmentation else None
    dev = FlatSequenceDataset(
        poses_train_2d, poses_train,
        margins=FlatSequenceDataset.training_margins(pad, causal_shift,
                                                     loop_cfg.chunk_length),
        flip_perms=flip_perms).to_device(device)
    sampler = ChunkedPairSampler(
        [p.shape[0] for p in poses_train_2d], loop_cfg.batch_size,
        loop_cfg.chunk_length, augment=args.data_augmentation)
    train_eval_batcher = _eval_batcher(args, pad, causal_shift, kps_perm, joints_perm,
                                       cameras_train, poses_train, poses_train_2d)
    print("INFO: Training on {} frames".format(train_eval_batcher.num_frames()))

    optimizer = make_optimizer(model, lr)
    trainer = SupervisedTrainer(model, loop_cfg, optimizer)
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
        step_rng = checkpoint.get("step_rng")
        if isinstance(step_rng, torch.Tensor) and step_rng.dtype == torch.uint8:
            generator.set_state(step_rng)
        set_learning_rate(optimizer, lr)

    print("** Note: reported losses are averaged over all frames and test-time "
          "augmentation is not used here.")
    print("** The final evaluation will be carried out after the last training "
          "epoch.")

    eval_sets = None
    if not args.no_eval:
        eval_sets = {"test": DeviceEvalSet(test_batcher, pad=pad, device=device),
                     "train": DeviceEvalSet(train_eval_batcher, pad=pad, device=device)}
    losses_3d_train, losses_3d_train_eval, losses_3d_valid = [], [], []
    train_seconds, train_steps, train_frames = 0.0, 0, 0

    while epoch < args.epochs:
        start_time = time.time()
        momentum = bn_momentum_for_epoch(loop_cfg, epoch - 1)
        losses, n_valids = [], []
        step_start = time.perf_counter()
        with full_float32():
            for meta, n_valid in sampler.next_epoch():
                losses.append(trainer.step(dev, meta, n_valid, momentum, generator))
                n_valids.append(n_valid)
        vals = torch.stack(losses).double().cpu().numpy()  # waits for the steps
        train_seconds += time.perf_counter() - step_start
        train_steps += len(losses)
        train_frames += sum(n_valids)
        weights = np.asarray(n_valids, np.float64)
        losses_3d_train.append(float(np.sum(vals * weights) / np.sum(weights)))

        if not args.no_eval:
            losses_3d_valid.append(eval_sets["test"].loss(evaluator, model))
            losses_3d_train_eval.append(eval_sets["train"].loss(evaluator, model))

        elapsed = (time.time() - start_time) / 60
        if args.no_eval:
            print("[%d] time %.2f lr %f 3d_train %f" % (
                epoch + 1, elapsed, lr, losses_3d_train[-1] * 1000))
        else:
            print("[%d] time %.2f lr %f 3d_train %f 3d_eval %f 3d_valid %f" % (
                epoch + 1, elapsed, lr, losses_3d_train[-1] * 1000,
                losses_3d_train_eval[-1] * 1000, losses_3d_valid[-1] * 1000))

        lr *= args.lr_decay
        set_learning_rate(optimizer, lr)
        epoch += 1

        if epoch % args.checkpoint_frequency == 0:
            chk_path = os.path.join(args.checkpoint, f"epoch_{epoch}.bin")
            print("Saving checkpoint to", chk_path)
            save_checkpoint(chk_path, {
                "epoch": epoch,
                "lr": lr,
                "random_state": sampler.random_state(),
                "optimizer": optimizer.state_dict(),
                "model_pos": model_state_dict(model),
                "model_traj": None,
                # The dropout generator's state: a resume replays the masks.
                "step_rng": generator.get_state(),
            })

    print(f"INFO: trained {train_steps} steps in {train_seconds:.3f} s "
          f"({train_frames / max(train_seconds, 1e-9):.1f} frames/s, engine "
          f"{args.train_engine}, device {device})")


def _final_evaluation(args, dataset, keypoints, subjects_test, action_filter,
                      model, evaluator, pad, causal_shift, kps_perm, joints_perm):
    """Action-wise protocols (per subject with ``--by-subject``); returns the
    number of frames evaluated."""
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
                            action_filter=action_filter)
    else:
        for subject in all_actions_by_subject.keys():
            print("Evaluating on subject", subject)
            evaluate_actionwise(evaluator, model, all_actions_by_subject[subject],
                                make_batcher, action_filter=action_filter)
            print("")
    return n_frames


if __name__ == "__main__":
    main()
