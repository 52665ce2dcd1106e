"""MotionBERT's DSTformer on the card at its published widths: K1 gathers the
51-float rows of (x, y, confidence) keypoints bit for bit, one supervised step at
2 clips of 243 frames in float32 (TF32 off) matches the float64 reference
(``perfbench/reference/dstformer.py``) within the benchmark cell's limits, and a
forward counts 10 spatial and 10 temporal attention calls.

Needs a CUDA device (marker ``gpu``; skipped elsewhere).  Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_dstformer_gpu.py
"""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import synth  # noqa: E402
from perfbench.drivers import train_dst  # noqa: E402
from perfbench.reference import dstformer as rd, train as rt  # noqa: E402
from videopose3d_torch import profiling  # noqa: E402
from videopose3d_torch.data.generators import (ChunkedPairSampler,  # noqa: E402
                                               FlatSequenceDataset)
from videopose3d_torch.evaluate import full_float32  # noqa: E402
from videopose3d_torch.models.dstformer import DSTformer  # noqa: E402
from videopose3d_torch.ops.kernels.gather_rows import (gather_windows,  # noqa: E402
                                                       gather_windows_plain)
from videopose3d_torch.train import (SupervisedTrainer, TrainLoopConfig,  # noqa: E402
                                     make_optimizer)

pytestmark = pytest.mark.gpu

CFG = json.loads((REPO / "perfbench/configs/h36m-dstformer-243f.json").read_text())
LIMITS = json.loads((REPO / "perfbench/limits/train-h36m243-dstformer-xla.json").read_text())
SEED = 2 ** 31 + 2027


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [3_000, 300_000])
def test_k1_gathers_51_float_rows_bitwise(cuda, rows):
    """Rows of 204 bytes, off a 16-byte word: the kernel's shifted copy."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    flat = torch.randn(rows, 51, generator=g, device=cuda)
    row0 = torch.randint(-5, rows, (16,), generator=g, device=cuda)
    row0[:2] = torch.tensor([0, rows - 243], device=cuda)
    assert torch.equal(gather_windows(flat, row0, window=243),
                       gather_windows_plain(flat, row0, window=243))


def test_one_step_at_two_clips_matches_the_reference(cuda):
    w0 = train_dst.make_weights(CFG, SEED, cuda)
    model = DSTformer(train_dst.model_config(CFG)).to(cuda)
    synth.load_into(model, w0)
    p2, p3 = synth.training_set({"sequences": 4, "frames_per_sequence": 600}, SEED, cuda)
    p2 = train_dst.with_confidence(p2, SEED, cuda)
    lengths, clip, perm = [len(p) for p in p2], CFG["maxlen"], synth.flip_perm(17)
    dev = FlatSequenceDataset(p2, p3, margins=FlatSequenceDataset.training_margins(0, 0, clip),
                              flip_perms=(perm, perm)).to_device(cuda)
    assert tuple(dev.flat_2d_padded.shape[1:]) == (51,)
    loop = TrainLoopConfig(batch_size=2, chunk_length=clip, pad=0, causal_shift=0,
                           learning_rate=2e-4, use_strided=False)
    meta, n_valid = next(ChunkedPairSampler(lengths, 2, clip, random_seed=11,
                                            augment=True).next_epoch())
    opt = make_optimizer(model, 2e-4)
    with full_float32():
        loss = float(SupervisedTrainer(model, loop, opt).step(dev, meta, n_valid, 0.0))
    beta1 = opt.param_groups[0]["betas"][0]
    grads = {n: float(opt.state[p]["exp_avg"].double().norm()) / (1 - beta1)
             for n, p in model.named_parameters()}
    changes = {n: float((p.detach().double() - w0[n].double()).norm())
               for n, p in model.named_parameters()}
    del model, opt, dev
    torch.cuda.empty_cache()
    chunks = rd.first_batches(lengths, 2, 1, clip, 11, True)[0]
    ref_losses, ref_grads, ref_params = rd.train_steps(
        w0, CFG, [rd.windows(p2, p3, chunks, perm, perm)], 2e-4, 0.01, torch.float64, cuda,
        group=2)
    ref_g = {k: float(g.norm()) for k, g in ref_grads.items()}
    ref_c = {k: float((p - w0[k].double()).norm()) for k, p in ref_params.items()}
    keep = rt.kept_leaves(ref_g)
    assert abs(loss - ref_losses[0]) / ref_losses[0] <= LIMITS["loss1_gap"]["limit"]
    assert rt.leaf_gap(grads, ref_g, keep) <= LIMITS["grad_gap"]["limit"]
    assert rt.leaf_gap(changes, ref_c, keep) <= LIMITS["change_gap"]["limit"]


def test_a_forward_counts_ten_and_ten_attention_calls(cuda):
    model = DSTformer(train_dst.model_config(CFG)).to(cuda)
    x = torch.randn(1, CFG["maxlen"], 17, 3, device=cuda)
    profiling.reset_counters()
    with torch.profiler.profile(), torch.no_grad(), full_float32():
        model(x)
    c = profiling.counters()
    assert c["dst.attention_spatial"] == c["dst.attention_temporal"] == 10
