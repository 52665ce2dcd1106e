"""The port's native (C++) sampler core, ``videopose3d_torch/native.py``:
bit-parity with numpy's legacy ``RandomState`` (raw MT19937 draws, row
permutations, the post-call RNG state), ``ChunkedPairSampler`` on either path,
resume across the paths and of an endless stream, and the build."""

import os
import pathlib

import numpy as np
import pytest

from videopose3d_torch import native
from videopose3d_torch.data.generators import ChunkedPairSampler

REPO = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the native sampler could not be built (no g++)")


def test_raw_mt19937_draws_match_numpy():
    want = np.random.RandomState(1234).randint(0, 2**32, size=1000, dtype=np.uint32)
    np.testing.assert_array_equal(native.raw_draws(np.random.RandomState(1234), 1000), want)


@pytest.mark.parametrize("seed,n", [(1234, 1), (1234, 2), (1234, 97), (4321, 1000), (0, 8)])
def test_permutation_matches_numpy(seed, n):
    pairs = np.arange(n * 4, dtype=np.int64).reshape(n, 4)
    rs_np, rs_nat = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):  # repeated permutations: the state must track exactly
        np.testing.assert_array_equal(native.permute_rows(rs_nat, pairs),
                                      rs_np.permutation(pairs))
    np.testing.assert_array_equal(rs_np.get_state()[1], rs_nat.get_state()[1])
    assert rs_np.get_state()[2] == rs_nat.get_state()[2]


def test_sampler_takes_the_native_core_by_default_and_equals_numpy():
    lengths = [37, 60, 11]
    assert ChunkedPairSampler(lengths, 8, 1).use_native
    a = ChunkedPairSampler(lengths, 8, 1, augment=True, use_native=False)
    b = ChunkedPairSampler(lengths, 8, 1, augment=True, use_native=True)
    for _ in range(2):
        batches = list(zip(a.next_epoch(), b.next_epoch()))
        assert len(batches) == a.num_batches == 27  # 216 pairs of 8
        for (ma, va), (mb, vb) in batches:
            np.testing.assert_array_equal(ma, mb)
            assert va == vb
    np.testing.assert_array_equal(a.random_state()[1], b.random_state()[1])


@pytest.mark.parametrize("saved_native", [True, False])
def test_resume_across_the_two_paths(saved_native):
    lengths = [29, 43]
    a = ChunkedPairSampler(lengths, 4, 1, use_native=saved_native)
    list(a.next_epoch())
    saved = a.random_state()
    resumed = []
    for use_native in (True, False):
        s = ChunkedPairSampler(lengths, 4, 1, use_native=use_native)
        s.set_random_state(saved)
        resumed.append([m for m, _ in s.next_epoch()])
    want = [m for m, _ in a.next_epoch()]
    for got in resumed:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("resume_native", [True, False])
def test_endless_stream_resumes_inside_a_native_permutation(resume_native):
    """stream_state taken mid-permutation from a native endless stream: a new
    sampler on either path goes on with the same batches."""
    lengths = [23, 31]
    a = ChunkedPairSampler(lengths, 4, 1, random_seed=4321, augment=True, endless=True,
                           use_native=True)
    it = a.next_epoch()
    for _ in range(a.num_batches + 5):  # into the second permutation
        next(it)
    state, rng = a.stream_state(), a.random_state()
    assert state is not None and state[0] == 5
    b = ChunkedPairSampler(lengths, 4, 1, random_seed=4321, augment=True, endless=True,
                           use_native=resume_native)
    b.set_random_state(rng)
    b.set_stream_state(state)
    jt = b.next_epoch()
    for _ in range(2 * a.num_batches):  # across the next permutation boundary
        (ma, va), (mb, vb) = next(it), next(jt)
        np.testing.assert_array_equal(ma, mb)
        assert va == vb


def test_reaper_spares_a_live_builders_temp_file(tmp_path, monkeypatch):
    """A temp file whose pid is alive (even another user's: EPERM) is left
    alone; one whose pid is gone is removed."""
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(native, "_BUILD_DIR", str(build))
    monkeypatch.setattr(native, "_LIB_PATH", str(build / "libsampler.so"))
    live = build / "libsampler.so.424242.tmp"
    dead = build / "libsampler.so.424243.tmp"
    live.write_text("another builder's g++ output, in progress")
    dead.write_text("left by a killed builder")
    real_kill = os.kill

    def fake_kill(pid, sig):
        if pid == 424242:
            raise PermissionError("alive, owned by another user")
        if pid == 424243:
            raise ProcessLookupError("no such process")
        return real_kill(pid, sig)

    monkeypatch.setattr(os, "kill", fake_kill)
    assert native._build() == str(build / "libsampler.so")
    assert live.exists() and not dead.exists()
    assert not list(build.glob(f"*.{os.getpid()}.tmp"))


def test_the_port_builds_into_its_own_directory():
    lib = pathlib.Path(native._LIB_PATH)
    assert lib.parent == REPO / "build" / "torch_native"
    assert lib.is_file()
    assert pathlib.Path(native._SRC) == REPO / "native" / "sampler.cpp"
