"""The traffic generators: seeded, with the sizes the traffic files state, the
same amount of work for every seed."""

import json

import numpy as np
from conftest import REPO

from perfbench import synth

TRAFFIC = REPO / "perfbench" / "traffic"


def load(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def test_training_set_is_human36m_sized_and_seeded():
    tr = load("train_h36m_b1024")
    assert (tr["sequences"], tr["frames_per_sequence"], tr["batch_size"]) == (600, 2600, 1024)
    small = {**tr, "sequences": 3, "frames_per_sequence": 50}
    a2, a3 = synth.training_set(small, 7, "cpu")
    b2, _ = synth.training_set(small, 7, "cpu")
    c2, _ = synth.training_set(small, 8, "cpu")
    assert [p.shape for p in a2] == [(50, 17, 2)] * 3
    assert [p.shape for p in a3] == [(50, 17, 3)] * 3
    assert all(np.array_equal(x, y) for x, y in zip(a2, b2))
    assert not np.array_equal(a2[0], c2[0])
    # Each sequence is a walk of its own: no jump carried over from the last one.
    assert np.abs(np.diff(a2[1], axis=0)).max() < 0.05


def test_eval_set_lengths_are_one_multiset_dealt_by_the_seed():
    tr = load("eval_h36m_test_xla")
    lengths = synth.eval_lengths(tr)
    assert len(lengths) == 2 * 15 * 2
    assert lengths.min() >= 1000 and lengths.max() <= 3500
    assert 480_000 < 4 * lengths.sum() < 600_000  # about 540 k frames with 4 cameras
    small = {**tr, "subjects": 1, "actions": 3, "takes": 1, "cameras": 2,
             "min_frames": 20, "max_frames": 40}
    one, two = synth.eval_set(small, 1, "cpu"), synth.eval_set(small, 2, "cpu")
    sizes = lambda s: sorted(len(v[0]) for a in s for v in a)
    assert sizes(one) == sizes(two)
    assert len(one) == 3 and all(len(a) == 2 for a in one)
    assert all(len(a[0][0]) == len(a[1][0]) for a in one)  # one take, one length
    again = synth.eval_set(small, 1, "cpu")
    assert np.array_equal(one[0][0][0], again[0][0][0])


def test_stream_tracks_loop_and_calibration_clips():
    tr = load("stream_live_b1024_k1")
    assert (tr["streams"], tr["track_frames"]) == (1024, 1024)
    assert tr["track_frames"] > 243 and tr["calibration_frames"] == 243 + 256
    small = {**tr, "streams": 5, "track_frames": 64, "calibration_clips": 2,
             "calibration_frames": 30}
    tracks = synth.stream_tracks(small, 3, "cpu")
    assert tracks.shape == (64, 5, 17, 2)
    step = np.abs(np.diff(tracks, axis=0)).max()
    assert np.abs(tracks[0] - tracks[-1]).max() <= 1.5 * step  # loops without a jump
    assert np.array_equal(tracks, synth.stream_tracks(small, 3, "cpu"))
    clips = synth.calibration_clips(tracks, small)
    assert clips.shape == (2, 30, 17, 2)
    assert np.array_equal(clips[1], tracks[:30, 4])


def test_weights_from_the_seed():
    cfg = json.loads((REPO / "perfbench" / "configs" / "h36m-243f.json").read_text())
    cfg = {**cfg, "channels": 16}
    w = synth.make_weights(cfg, 5, "cpu")
    assert w["layers_conv.0.weight"].shape == (16, 16, 3)
    assert float(w["layers_bn.3.running_var"].min()) >= 0.5
    assert float(w["expand_conv.weight"].abs().max()) <= 1 / np.sqrt(34 * 3)
    assert all(np.array_equal(a, b) for a, b in
               zip(w.values(), synth.make_weights(cfg, 5, "cpu").values()))
