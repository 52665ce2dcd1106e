"""The port's own spans and counters (``profiling.span`` / ``count``): free and
silent with no profiler running; under a CPU ``torch.profiler`` the trainers,
the evaluator and the streaming lifter record their ``vp3d.*`` spans nested as
the work runs; outputs bit-identical with and without the profiler;
``device_trace`` writes ``counters.json``; the benchmark's own patch points still
see the calls they wrap."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parallel_workers as W
from videopose3d_torch import evaluate as ev
from videopose3d_torch import profiling
from videopose3d_torch import train as ttrain
from videopose3d_torch.data import generators as tgen
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
from videopose3d_torch.streaming import StreamingCausalLifter

REPO = Path(__file__).resolve().parents[1]
BUCKET = 16
EVAL_LENGTHS = (21, 40, 33)
TRAIN_SPANS = ["upload", "assemble", "forward", "loss", "backward", "optimizer"]


def _spans(prof):
    """[(name, start, end, thread)] of the ``vp3d.`` and ``bench.`` ranges and
    the ``K2 `` ranges, in order of their start."""
    out = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
           if e.name.startswith(("vp3d.", "bench.", "K2 "))]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(spans, outer):
    """For each ``outer`` range, the names of the ranges inside it, in order."""
    groups = []
    for name, a, b, tid in spans:
        if name == outer:
            groups.append([n for n, a2, b2, t2 in spans
                           if t2 == tid and a <= a2 and b2 <= b and (n, a2, b2) != (name, a, b)])
    return groups


def _children(group, prefix):
    """The names in ``group`` that are ``prefix`` + one more dotted part."""
    return [n for n in group if n.startswith(prefix) and "." not in n[len(prefix):]]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


# -- set-ups -------------------------------------------------------------------


def _trainer(engine="xla"):
    p2, p3, _ = W.videos(**W.LABELED)
    dev = W._dataset(p2, p3, None)
    model = W.model(engine=engine, dropout=0.25, seed=3)
    loop = ttrain.TrainLoopConfig(batch_size=W.BATCH, chunk_length=1, pad=W.PAD,
                                  causal_shift=0)
    trainer = ttrain.SupervisedTrainer(model, loop, ttrain.make_optimizer(model, 1e-3))
    meta, n_valid = next(iter(tgen.ChunkedPairSampler([len(p) for p in p2], W.BATCH, 1,
                                                      random_seed=1).next_epoch()))

    def step():
        gen = torch.Generator().manual_seed(11)
        return trainer.step(dev, meta, n_valid, 0.1, generator=gen)
    return model, step


def _semi_trainer():
    p2, p3, cams = W.videos(**W.LABELED)
    u2, _, ucams = W.videos(**W.UNLABELED)
    dev, dev_semi = W._dataset(p2, p3, cams), W._dataset(u2, None, ucams)
    pos, traj = W.model(seed=1), W.model(joints_out=1, seed=2)
    loop = ttrain.TrainLoopConfig(batch_size=W.BATCH, chunk_length=1, pad=W.PAD,
                                  causal_shift=0)
    trainer = ttrain.SemiSupervisedTrainer(pos, traj, loop,
                                           ttrain.make_optimizer([pos, traj], 1e-3),
                                           W.PARENTS)
    meta, nv = next(iter(tgen.ChunkedPairSampler([len(p) for p in p2], W.BATCH, 1,
                                                 random_seed=1).next_epoch()))
    meta_u, nv_u = next(iter(tgen.ChunkedPairSampler([len(u) for u in u2], W.BATCH, 1,
                                                     random_seed=2).next_epoch()))
    return lambda: trainer.step(dev, dev_semi, meta, nv, meta_u, nv_u, 0.1, False)


def _evaluation():
    p2, p3, _ = W.videos(seed=9, lengths=EVAL_LENGTHS)
    perm = W.flip_perm()
    net = W.model(seed=4).eval()
    evaluator = ev.Evaluator(net.config, joints_flip_perm=perm, device=W.CPU)
    batcher = tgen.UnchunkedBatcher(None, p3, p2, pad=W.PAD, causal_shift=0, augment=True,
                                    kps_flip_perm=perm, joints_flip_perm=perm,
                                    bucket=BUCKET)
    return lambda: ev.evaluate(evaluator, net, batcher, verbose=False)


def _lifter(engine, frames_per_step=1):
    from videopose3d_torch.ops.kernels.temporal_block_int8 import quantize_temporal_model
    cfg = TemporalModelConfig(W.J, 2, W.J, (3, 3, 3), causal=True, channels=W.CHANNELS)
    torch.manual_seed(6)
    net = TemporalModel(cfg).eval()
    k = frames_per_step
    frames = np.random.default_rng(6).standard_normal((4, 30, W.J, 2)).astype(np.float32)
    q = (quantize_temporal_model(cfg, net, torch.from_numpy(frames[:1]))
         if engine == "int8" else None)
    lifter = StreamingCausalLifter(cfg, net, engine=engine, quantized=q, device=W.CPU,
                                   frames_per_step=k)
    def run():
        lifter.reset(frames[:, 0])
        return torch.stack([lifter.step(frames[:, t] if k == 1 else frames[:, t:t + k])
                            for t in range(0, 8, k)])
    return run


# -- with no profiler ----------------------------------------------------------


def test_no_profiler_no_range_and_no_count(monkeypatch):
    """With no profiler, ``span`` hands back the one shared null context and
    never constructs a ``record_function`` (patched to raise), and ``count``
    moves nothing, through a train step, an evaluation and a stream."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler")
    monkeypatch.setattr(profiling, "record_function", refuse)
    profiling.reset_counters()
    assert profiling.span("vp3d.x") is profiling.span("vp3d.y")
    with profiling.span("vp3d.x"):
        profiling.count("eval.frames", 5)
    _trainer("pallas")[1]()
    _semi_trainer()()
    _evaluation()()
    _lifter("bf16")()
    assert profiling.counters() == {}


def test_counters_are_copies_and_reset():
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("a")
        profiling.count("a", 4)
    got = profiling.counters()
    assert got == {"a": 5}
    got["a"] = 0
    assert profiling.counters() == {"a": 5}
    profiling.reset_counters()
    assert profiling.counters() == {}


# -- the spans under a profiler ------------------------------------------------


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_train_step_spans(engine):
    _, step = _trainer(engine)
    _, spans = _profiled(step)
    (group,) = _inside(spans, "vp3d.train.step")
    assert _children(group, "vp3d.train.") == [f"vp3d.train.{s}" for s in TRAIN_SPANS]
    if engine == "pallas":  # K2 on its plain versions: one range a block each way
        (fwd,) = _inside(spans, "vp3d.train.forward")
        (bwd,) = _inside(spans, "vp3d.train.backward")
        assert fwd.count("vp3d.k2.forward") == len(W.ARCH) - 1
        assert bwd.count("vp3d.k2.backward") == len(W.ARCH) - 1
    else:
        assert not any(n.startswith("vp3d.k2.") for n, *_ in spans)


def test_semi_train_step_spans():
    """A full step: the supervised step's spans, each network's forward inside
    ``forward``, the back-projection and the bone term inside ``loss``, and the
    valid rows and the step counted."""
    profiling.reset_counters()
    _, spans = _profiled(_semi_trainer())
    (group,) = _inside(spans, "vp3d.train.step")
    nested = {"vp3d.train.pose", "vp3d.train.traj", "vp3d.train.project",
              "vp3d.train.bones"}
    assert [n for n in _children(group, "vp3d.train.") if n not in nested] == \
        [f"vp3d.train.{s}" for s in TRAIN_SPANS]
    (fwd,) = _inside(spans, "vp3d.train.forward")
    assert _children(fwd, "vp3d.train.") == ["vp3d.train.pose", "vp3d.train.traj"]
    (loss,) = _inside(spans, "vp3d.train.loss")
    assert _children(loss, "vp3d.train.") == ["vp3d.train.project", "vp3d.train.bones"]
    counters = profiling.counters()
    assert counters["train.full_steps"] == 1 and "train.warmup_steps" not in counters
    assert counters["train.rows_labeled"] > 0 and counters["train.rows_unlabeled"] > 0


def test_evaluate_spans_and_counters():
    profiling.reset_counters()
    _, spans = _profiled(_evaluation())
    n = len(EVAL_LENGTHS)
    predicts = _inside(spans, "vp3d.eval.predict")
    assert len(predicts) == n
    for group in predicts:
        assert _children(group, "vp3d.eval.") == ["vp3d.eval.upload", "vp3d.eval.infer",
                                                  "vp3d.eval.merge"]
    protocols = _inside(spans, "vp3d.eval.protocols")
    assert len(protocols) == n
    for group in protocols:
        assert _children(group, "vp3d.eval.") == ["vp3d.eval.mpjpe", "vp3d.eval.n_mpjpe",
                                                  "vp3d.eval.p_mpjpe", "vp3d.eval.mpjve"]
    top = [s[0] for s in spans if s[0] in ("vp3d.eval.fetch", "vp3d.eval.protocols")]
    assert top == ["vp3d.eval.fetch", "vp3d.eval.protocols"] * n
    assert profiling.counters() == {
        "eval.frames": sum(EVAL_LENGTHS),
        "eval.frames_computed": sum(-(-t // BUCKET) * BUCKET for t in EVAL_LENGTHS)}


def test_cpu_evaluator_counts_no_protocols_on_device():
    """An evaluator on the CPU keeps the host protocols: the device counter is absent."""
    profiling.reset_counters()
    _profiled(_evaluation())
    assert "eval.protocols_on_device" not in profiling.counters()
    assert profiling.counters()["eval.frames"] == sum(EVAL_LENGTHS)


def test_host_protocols_stay_globals_of_evaluate():
    """The benchmark's eval cells wrap these module globals by name (``_protocol_spans``)."""
    from videopose3d_torch.ops import losses
    for name in ("mpjpe_np", "n_mpjpe_np", "p_mpjpe", "mean_velocity_error"):
        assert getattr(ev, name) is getattr(losses, name)


def test_device_eval_set_losses_span():
    p2, p3, _ = W.videos(seed=9, lengths=EVAL_LENGTHS)
    batcher = tgen.UnchunkedBatcher(None, p3, p2, pad=W.PAD, causal_shift=0, bucket=BUCKET)
    eval_set = ev.DeviceEvalSet(batcher, pad=W.PAD, device=W.CPU)
    net = W.model(seed=4).eval()
    evaluator = ev.Evaluator(net.config, device=W.CPU)
    _, spans = _profiled(lambda: eval_set.losses(evaluator, net))
    assert [s[0] for s in spans] == ["vp3d.eval.losses"]


@pytest.mark.parametrize("engine,k", [("bf16", 1), ("int8", 1), ("bf16", 2)])
def test_stream_step_spans(engine, k):
    _, spans = _profiled(_lifter(engine, k))
    steps = _inside(spans, "vp3d.stream.step")
    assert len(steps) == 8 // k
    for group in steps:
        assert _children(group, "vp3d.stream.") == [
            "vp3d.stream.frames", "vp3d.stream.ring", "vp3d.stream.expand",
            "vp3d.stream.blocks"]


# -- the same outputs either way -------------------------------------------------


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_train_step_bitwise_with_and_without_profiler(engine):
    runs = []
    for traced in (False, True):
        model, step = _trainer(engine)
        loss = _profiled(step)[0] if traced else step()
        runs.append((loss, [p.detach().clone() for p in model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_semi_losses_bitwise_with_and_without_profiler():
    plain = _semi_trainer()()
    traced = _profiled(_semi_trainer())[0]
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


@pytest.mark.parametrize("engine", ["bf16", "int8"])
def test_stream_poses_bitwise_with_and_without_profiler(engine):
    run = _lifter(engine)
    plain = run()
    assert torch.equal(_profiled(run)[0], plain)


def test_evaluate_numbers_equal_with_and_without_profiler():
    run = _evaluation()
    assert _profiled(run)[0] == run()


# -- device_trace's counters.json ------------------------------------------------


def test_device_trace_writes_counters_and_resets_them(tmp_path):
    run = _evaluation()
    profiling.count("eval.frames", 1000)  # no profiler: does not count
    with profiling.device_trace(str(tmp_path / "one"), "cpu"):
        run()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("stale", 3)  # left from an earlier profiled stretch
    with profiling.device_trace(str(tmp_path / "two"), "cpu"):
        run()
        run()
    one = json.loads((tmp_path / "one" / "counters.json").read_text())
    two = json.loads((tmp_path / "two" / "counters.json").read_text())
    assert one == {"eval.frames": sum(EVAL_LENGTHS),
                   "eval.frames_computed": sum(-(-t // BUCKET) * BUCKET
                                               for t in EVAL_LENGTHS)}
    assert two == {k: 2 * v for k, v in one.items()}
    assert len(list((tmp_path / "two").glob("*.pt.trace.json"))) == 1


# -- the benchmark's patch points ---------------------------------------------------


def _traffic_module(kind):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from perfbench.harness import load_module
    return load_module(REPO / "perfbench" / "drivers" / f"{kind}.py", kind)


def test_benchmark_protocol_patch_sees_the_protocol_calls():
    """``perfbench/drivers/eval.py``'s ``bench.eval.protocols`` ranges, set on the module
    globals ``evaluate()`` calls, still open once per protocol and video, each
    inside the program's span of that protocol."""
    evaluation = _traffic_module("eval").Driver({}, {}, 0, "cpu")
    run = _evaluation()
    with evaluation._protocol_spans():
        _, spans = _profiled(run)
    n = len(EVAL_LENGTHS)
    assert sum(s[0] == "bench.eval.protocols" for s in spans) == 4 * n
    for name in ("mpjpe", "n_mpjpe", "p_mpjpe", "mpjve"):
        assert [g for g in _inside(spans, f"vp3d.eval.{name}")] == [["bench.eval.protocols"]] * n


def test_benchmark_k2_ranges_wrap_the_program_spans():
    """``perfbench/drivers/train.py``'s ``K2 forward`` / ``K2 backward`` ranges around
    ``FusedTrainBlock`` hold the program's ``vp3d.k2.*`` spans."""
    _, step = _trainer("pallas")
    with _traffic_module("train").k2_ranges():
        _, spans = _profiled(step)
    blocks = len(W.ARCH) - 1
    assert _inside(spans, "K2 forward") == [["vp3d.k2.forward"]] * blocks
    assert _inside(spans, "K2 backward") == [["vp3d.k2.backward"]] * blocks
