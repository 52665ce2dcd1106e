"""Command-line interface.

The flag surface of ``videopose3d_tpu/arguments.py`` (the reference's flags with
their names, defaults and semantics, and the JAX package's own), plus
``--device`` and ``--model``.  The JAX package's TPU knobs are accepted and
ignored, so one command line runs in both packages.

``--model dstformer`` trains and evaluates MotionBERT's DSTformer at its
published sizes (``models/dstformer.py``) in place of the temporal ConvNet:
``-b`` then counts clips of 243 frames (default 32), ``-lr`` defaults to 2e-4 and
``-lrd`` to 0.99 (AdamW, the recipe's), and the ConvNet's flags are refused.
"""

from __future__ import annotations

import argparse
import sys

# Defaults that depend on --model: (tcn, dstformer).
MODEL_DEFAULTS = {"batch_size": (1024, 32), "learning_rate": (0.001, 2e-4),
                  "lr_decay": (0.95, 0.99)}
# Flags of the temporal ConvNet (its shape, form and dropout) and of
# semi-supervised training, which --model dstformer refuses.
CONVNET_ONLY = ("architecture", "causal", "channels", "dense", "dropout", "stride",
                "disable_optimizations", "subjects_unlabeled", "warmup",
                "linear_projection", "bone_length_term", "no_proj", "compute_dtype")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Training script")

    # General arguments
    parser.add_argument("-d", "--dataset", default="h36m", type=str, metavar="NAME",
                        help="target dataset")
    parser.add_argument("-k", "--keypoints", default="cpn_ft_h36m_dbb", type=str,
                        metavar="NAME", help="2D detections to use")
    parser.add_argument("-str", "--subjects-train", default="S1,S5,S6,S7,S8",
                        type=str, metavar="LIST",
                        help="training subjects separated by comma")
    parser.add_argument("-ste", "--subjects-test", default="S9,S11", type=str,
                        metavar="LIST", help="test subjects separated by comma")
    parser.add_argument("-sun", "--subjects-unlabeled", default="", type=str,
                        metavar="LIST",
                        help="unlabeled subjects separated by comma for self-supervision")
    parser.add_argument("-a", "--actions", default="*", type=str, metavar="LIST",
                        help="actions to train/test on, separated by comma, or * for all")
    parser.add_argument("-c", "--checkpoint", default="checkpoint", type=str,
                        metavar="PATH", help="checkpoint directory")
    parser.add_argument("--checkpoint-frequency", default=10, type=int, metavar="N",
                        help="create a checkpoint every N epochs")
    parser.add_argument("-r", "--resume", default="", type=str, metavar="FILENAME",
                        help="checkpoint to resume (file name)")
    parser.add_argument("--evaluate", default="", type=str, metavar="FILENAME",
                        help="checkpoint to evaluate (file name)")
    parser.add_argument("--render", action="store_true",
                        help="visualize a particular video")
    parser.add_argument("--by-subject", action="store_true",
                        help="break down error by subject (on evaluation)")
    parser.add_argument("--export-training-curves", action="store_true",
                        help="save training curves as .png images")

    # Model arguments
    parser.add_argument("-s", "--stride", default=1, type=int, metavar="N",
                        help="chunk size to use during training")
    parser.add_argument("-e", "--epochs", default=60, type=int, metavar="N",
                        help="number of training epochs")
    parser.add_argument("-b", "--batch-size", default=None, type=int, metavar="N",
                        help="batch size in terms of predicted frames (default 1024; "
                             "--model dstformer: clips of 243 frames, default 32)")
    parser.add_argument("-drop", "--dropout", default=0.25, type=float, metavar="P",
                        help="dropout probability")
    parser.add_argument("-lr", "--learning-rate", default=None, type=float,
                        metavar="LR", help="initial learning rate (default 0.001; "
                                           "--model dstformer: 2e-4)")
    parser.add_argument("-lrd", "--lr-decay", default=None, type=float, metavar="LR",
                        help="learning rate decay per epoch (default 0.95; "
                             "--model dstformer: 0.99)")
    parser.add_argument("-no-da", "--no-data-augmentation", dest="data_augmentation",
                        action="store_false", help="disable train-time flipping")
    parser.add_argument("-no-tta", "--no-test-time-augmentation",
                        dest="test_time_augmentation", action="store_false",
                        help="disable test-time flipping")
    parser.add_argument("-arc", "--architecture", default="3,3,3", type=str,
                        metavar="LAYERS", help="filter widths separated by comma")
    parser.add_argument("--causal", action="store_true",
                        help="use causal convolutions for real-time processing")
    parser.add_argument("-ch", "--channels", default=1024, type=int, metavar="N",
                        help="number of channels in convolution layers")

    # Experimental
    parser.add_argument("--subset", default=1, type=float, metavar="FRACTION",
                        help="reduce dataset size by fraction")
    parser.add_argument("--downsample", default=1, type=int, metavar="FACTOR",
                        help="downsample frame rate by factor (semi-supervised)")
    parser.add_argument("--warmup", default=1, type=int, metavar="N",
                        help="warm-up epochs for semi-supervision")
    parser.add_argument("--no-eval", action="store_true",
                        help="disable epoch evaluation while training (small speed-up)")
    parser.add_argument("--dense", action="store_true",
                        help="use dense convolutions instead of dilated convolutions")
    parser.add_argument("--disable-optimizations", action="store_true",
                        help="disable optimized model for single-frame predictions")
    parser.add_argument("--linear-projection", action="store_true",
                        help="use only linear coefficients for semi-supervised projection")
    parser.add_argument("--no-bone-length", action="store_false",
                        dest="bone_length_term",
                        help="disable bone length term in semi-supervised settings")
    parser.add_argument("--no-proj", action="store_true",
                        help="disable projection for semi-supervised setting")

    # Visualization
    parser.add_argument("--viz-subject", type=str, metavar="STR",
                        help="subject to render")
    parser.add_argument("--viz-action", type=str, metavar="STR",
                        help="action to render")
    parser.add_argument("--viz-camera", type=int, default=0, metavar="N",
                        help="camera to render")
    parser.add_argument("--viz-video", type=str, metavar="PATH",
                        help="path to input video")
    parser.add_argument("--viz-skip", type=int, default=0, metavar="N",
                        help="skip first N frames of input video")
    parser.add_argument("--viz-output", type=str, metavar="PATH",
                        help="output file name (.gif or .mp4)")
    parser.add_argument("--viz-export", type=str, metavar="PATH",
                        help="output file name for coordinates")
    parser.add_argument("--viz-bitrate", type=int, default=3000, metavar="N",
                        help="bitrate for mp4 videos")
    parser.add_argument("--viz-no-ground-truth", action="store_true",
                        help="do not show ground-truth poses")
    parser.add_argument("--viz-limit", type=int, default=-1, metavar="N",
                        help="only render first N frames")
    parser.add_argument("--viz-downsample", type=int, default=1, metavar="N",
                        help="downsample FPS by a factor N")
    parser.add_argument("--viz-size", type=int, default=5, metavar="N",
                        help="image size")

    # Port-specific (no reference equivalent)
    parser.add_argument("--model", default="tcn", type=str, choices=["tcn", "dstformer"],
                        help="the pose model: 'tcn' the dilated temporal ConvNet "
                             "(default), 'dstformer' MotionBERT's DSTformer at its "
                             "published sizes (depth 5, 512 features, 8 heads, MLP "
                             "ratio 2, clips of 243 frames), trained with AdamW on "
                             "MPJPE + 0.5 N-MPJPE + 20 velocity error")
    parser.add_argument("--device", default="cuda", type=str, metavar="DEVICE",
                        help="torch device to run the model on: 'cuda' (default; "
                             "fails when no card is present; cuda:$LOCAL_RANK under "
                             "python -m torch.distributed.run) or 'cpu'")
    parser.add_argument("--data-dir", default="data", type=str, metavar="PATH",
                        help="directory holding data_3d_*.npz / data_2d_*.npz archives")
    parser.add_argument("--compute-dtype", default="float32", type=str,
                        choices=["float32", "bfloat16", "mixed"],
                        help="dtype of the fused engine's matmul operands and "
                             "activations ('mixed' runs as bfloat16 there); the "
                             "xla engine always evaluates in float32")
    parser.add_argument("--eval-bucket", default=128, type=int, metavar="N",
                        help="bucket whole-video eval lengths to multiples of N frames")
    parser.add_argument("--eval-bucket-pow2", action="store_true",
                        help="bucket eval lengths to powers of two (starting at "
                             "--eval-bucket)")
    parser.add_argument("--seed", default=0, type=int, metavar="N",
                        help="model init and dropout-mask seed")
    parser.add_argument("--serving-engine", default="xla", type=str,
                        choices=["xla", "fused", "int8"],
                        help="pose-model inference engine for evaluation: plain "
                             "float32 torch with TF32 off (metric grade, default), "
                             "the fused CUDA block kernels at --compute-dtype, or "
                             "the w8a8 int8 CUDA kernels (bulk serving, mm-level "
                             "accuracy; calibrated on the first evaluated video)")
    parser.add_argument("--train-engine", default="xla", type=str,
                        choices=["xla", "pallas"],
                        help="strided train-block engine: 'xla' is the plain torch "
                             "block, 'pallas' the hand-written CUDA train-block "
                             "kernels (forward and backward; the plain versions "
                             "of those kernels on --device cpu)")
    parser.add_argument("--gather-impl", default="auto", type=str,
                        choices=["auto", "xla", "pallas"],
                        help="batch-assembly window copy: 'pallas' is the CUDA "
                             "window-gather kernel, 'xla' plain indexing, 'auto' "
                             "(default) the kernel on --device cuda and plain "
                             "indexing on --device cpu")

    parser.add_argument("--no-mesh", action="store_true",
                        help="do not join the launcher's process group: trains on "
                             "one process even under a one-process launcher "
                             "(python -m torch.distributed.run); refused when "
                             "WORLD_SIZE > 1, which would train independent copies")
    parser.add_argument("--eval-devices", default=0, type=int, metavar="N",
                        help="local devices to round-robin evaluation videos over "
                             "(the protocol numbers do not depend on N); 0 "
                             "(default): every local card of a single-process CUDA "
                             "run, the process's own device otherwise")

    parser.add_argument("--profile-dir", default=None, type=str, metavar="PATH",
                        help="capture a torch.profiler device trace of the first "
                             "training epoch into this directory")
    parser.add_argument("--metrics-log", default=None, type=str, metavar="PATH",
                        help="append per-epoch structured metrics (JSON lines)")

    # TPU-only knobs of the JAX package: accepted and ignored here.
    tpu_only = "TPU-only (JAX package); accepted and ignored by videopose3d_torch"
    parser.add_argument("--rng-impl", default="rbg", type=str,
                        choices=["rbg", "threefry2x32"], help=tpu_only)
    parser.add_argument("--checkpoint-format", default="pickle", type=str,
                        choices=("pickle", "orbax"), metavar="FMT", help=tpu_only)
    parser.add_argument("--remat", action="store_true", help=tpu_only)
    parser.add_argument("--no-scan-epoch", dest="scan_epoch", action="store_false",
                        help=tpu_only)
    parser.add_argument("--scan-chunk", default=0, type=int, metavar="STEPS",
                        help=tpu_only)

    parser.set_defaults(bone_length_term=True)
    parser.set_defaults(data_augmentation=True)
    parser.set_defaults(test_time_augmentation=True)

    args = parser.parse_args(argv)
    for dest, defaults in MODEL_DEFAULTS.items():
        if getattr(args, dest) is None:
            setattr(args, dest, defaults[args.model == "dstformer"])
    if args.model == "dstformer":
        _check_dstformer(parser, args, sys.argv[1:] if argv is None else argv)

    # Invalid-combination checks (as the reference).
    if args.resume and args.evaluate:
        print("Invalid flags: --resume and --evaluate cannot be set at the same time")
        raise SystemExit(1)
    if args.export_training_curves and args.no_eval:
        print("Invalid flags: --export-training-curves and --no-eval cannot be set "
              "at the same time")
        raise SystemExit(1)

    return args


def _check_dstformer(parser, args, argv) -> None:
    """Refuse what ``--model dstformer`` cannot run: a flag of the ConvNet or of
    semi-supervised training given on the command line, and the engines that
    have no DSTformer kernels."""
    given = [a for a in parser._actions if a.dest in CONVNET_ONLY and any(
        tok == opt or tok.startswith(opt + "=") for tok in argv for opt in a.option_strings)]
    if given:
        parser.error("--model dstformer does not take " + ", ".join(
            "/".join(a.option_strings) for a in given) + " (ConvNet or semi-supervised "
            "flags; the DSTformer's sizes are the published ones)")
    if args.train_engine != "xla":
        from videopose3d_torch.models.dstformer import MISSING_KERNELS
        parser.error(f"--model dstformer: --train-engine {args.train_engine} needs "
                     f"hand-written kernels the port does not have for it ({MISSING_KERNELS}); "
                     "it trains on --train-engine xla (cuBLAS float32, TF32 off)")
    if args.serving_engine != "xla":
        parser.error(f"--model dstformer: --serving-engine {args.serving_engine} has no "
                     "DSTformer kernels; it evaluates on --serving-engine xla")
