"""``videopose3d_torch.checkpoint.AsyncCheckpointer``: round trips, errors
surfacing on ``wait()``, one save in flight at a time, and the snapshot that
keeps a save from seeing the optimizer step taken right after it."""

import threading
import time

import numpy as np
import pytest
import torch

from videopose3d_torch.checkpoint import (AsyncCheckpointer, load_any_checkpoint,
                                          model_state_dict, save_checkpoint, snapshot)
from videopose3d_torch.models.temporal import TemporalModel, TemporalModelConfig
from videopose3d_torch.train import make_optimizer


def _model():
    torch.manual_seed(0)
    return TemporalModel(TemporalModelConfig(17, 2, 17, (3, 3), channels=16))


def test_round_trip_of_a_dict_and_of_a_callable(tmp_path):
    model = _model()
    rng_state = np.random.RandomState(3).get_state()
    payload = {"epoch": 4, "lr": 0.5, "model_pos": model_state_dict(model, copy=False),
               "model_traj": None, "random_state": rng_state, "optimizer": None,
               "nested": [torch.arange(3), (np.ones(2), "x")]}
    ckpt = AsyncCheckpointer()
    ckpt.save(str(tmp_path / "a.bin"), payload)
    ckpt.save(str(tmp_path / "b.bin"), lambda: {**payload, "epoch": 5})
    ckpt.wait()
    for name, epoch in (("a.bin", 4), ("b.bin", 5)):
        got = load_any_checkpoint(str(tmp_path / name))
        assert got["epoch"] == epoch and got["lr"] == 0.5
        for k, v in model_state_dict(model).items():
            np.testing.assert_array_equal(got["model_pos"][k], v.numpy())
        np.testing.assert_array_equal(got["random_state"][1], rng_state[1])
        assert torch.equal(got["nested"][0], torch.arange(3))
        assert got["nested"][1][1] == "x"
    assert not list(tmp_path.glob("*.tmp"))


def test_a_background_error_surfaces_on_wait(tmp_path):
    def failing(path, payload):
        raise OSError("disk full")

    ckpt = AsyncCheckpointer()
    ckpt.save(str(tmp_path / "x.bin"), {"epoch": 1}, save_fn=failing)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    ckpt.wait()  # reported once
    ckpt.save(str(tmp_path / "y.bin"), {"epoch": 2}, save_fn=failing)
    with pytest.raises(OSError, match="disk full"):  # the next save joins first
        ckpt.save(str(tmp_path / "z.bin"), {"epoch": 3})


def test_saves_are_serialised(tmp_path):
    spans, lock = [], threading.Lock()

    def slow(path, payload):
        start = time.perf_counter()
        time.sleep(0.05)
        save_checkpoint(path, payload)
        with lock:
            spans.append((start, time.perf_counter()))

    ckpt = AsyncCheckpointer()
    for i in range(3):
        ckpt.save(str(tmp_path / f"{i}.bin"), {"epoch": i}, save_fn=slow)
    ckpt.wait()
    assert len(spans) == 3
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start
    assert [load_any_checkpoint(str(tmp_path / f"{i}.bin"))["epoch"] for i in range(3)] \
        == [0, 1, 2]


def test_an_optimizer_step_after_save_does_not_reach_the_file(tmp_path):
    """The in-place hazard: the step right after ``save`` rewrites the weights
    and the AMSGrad moments in place while the writer is still busy; the file
    holds the state of the moment of ``save``."""
    model = _model()
    optimizer = make_optimizer(model, 1e-2)
    x = torch.randn(4, 27, 17, 2)

    def step():
        optimizer.zero_grad()
        model(x).square().mean().backward()
        optimizer.step()

    step()
    before = {k: v.clone() for k, v in model_state_dict(model).items()}
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in optimizer.state_dict()["state"].items()}
    release = threading.Event()

    def held(path, payload):
        release.wait(10)
        save_checkpoint(path, payload)

    ckpt = AsyncCheckpointer()
    ckpt.save(str(tmp_path / "e.bin"), {"epoch": 1, "lr": 1e-2, "model_traj": None,
                                        "model_pos": model_state_dict(model, copy=False),
                                        "optimizer": optimizer.state_dict()},
              save_fn=held)
    step()
    release.set()
    ckpt.wait()
    got = load_any_checkpoint(str(tmp_path / "e.bin"))
    changed = [k for k, v in model_state_dict(model).items() if not torch.equal(v, before[k])]
    assert changed  # the step did move the live weights
    for k, v in before.items():
        np.testing.assert_array_equal(got["model_pos"][k], v.numpy(), err_msg=k)
    for i, state in moments.items():
        for k, v in state.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)


def test_snapshot_copies_numpy_and_keeps_other_leaves():
    arr = np.zeros(3)
    t = torch.zeros(2)
    snap = snapshot({"a": arr, "t": t, "s": "x", "n": None}).to_host()
    arr[0], t[0] = 1, 1
    assert snap["a"][0] == 0 and snap["t"][0] == 0
    assert snap["s"] == "x" and snap["n"] is None
