"""The training data path of videopose3d_torch against videopose3d_tpu on the same
seeded inputs: the window gather's plain version (kernel K1's twin) against the
JAX Pallas gather (interpret mode) and the XLA ``dynamic_slice`` gather, the
batch assembly, and the chunk sampler.  Pure data movement and host RNG:
everything is bitwise equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu.data import generators as jgen
from videopose3d_tpu.ops.pallas.gather_rows import gather_windows
from videopose3d_torch.data import generators as tgen
from videopose3d_torch.ops.kernels.gather_rows import (gather_windows as t_gather,
                                                       gather_windows_plain)

from torch_port_helpers import H36M_KPS_LEFT, H36M_KPS_RIGHT


def _torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _bits(t):
    """Raw bits of a float32/bfloat16 tensor, for bitwise comparison."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


@pytest.mark.parametrize("jdt,tdt,align", [(jnp.float32, torch.float32, 8),
                                           (jnp.bfloat16, torch.bfloat16, 16)])
def test_plain_gather_equals_pallas_gather(jdt, tdt, align):
    rng = np.random.default_rng(0)
    rows, cols, window = 1024, 34, 81
    flat_j = jnp.asarray(rng.standard_normal((rows, cols))).astype(jdt)
    # The Pallas kernel's contract: row0 + window + align - 1 <= rows.
    row0 = np.concatenate([np.arange(align, dtype=np.int32) + 64,
                           rng.integers(0, rows - window - align + 1, 24).astype(np.int32),
                           np.asarray([0, rows - window - align + 1], np.int32)])
    want = gather_windows(flat_j, jnp.asarray(row0), window=window, interpret=True)
    got = gather_windows_plain(_torch(flat_j, tdt), torch.from_numpy(row0), window=window)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(_torch(want, tdt)))


@pytest.mark.parametrize("out_cols", [None, 17])
def test_plain_gather_equals_dynamic_slice_with_clamping(out_cols):
    rng = np.random.default_rng(1)
    rows, cols, window = 300, 34, 27
    flat = rng.standard_normal((rows, cols)).astype(np.float32)
    # Starts past the end: dynamic_slice clamps them to rows - window.
    row0 = np.asarray([0, 5, rows - window, rows - window + 1, rows, 10_000], np.int32)
    want = np.stack([np.asarray(jax.lax.dynamic_slice(
        jnp.asarray(flat), (int(r), 0), (window, cols))) for r in row0])
    # Negative starts: dynamic_slice first wraps them as Python indexing does;
    # the port clamps them to row 0, and neither reads outside the stream.
    row0 = np.concatenate([row0, np.asarray([-50, -1], np.int32)])
    want = np.concatenate([want, np.stack([flat[:window]] * 2)])
    oc = cols if out_cols is None else out_cols
    for fn in (gather_windows_plain, t_gather):  # on the CPU the wrapper is the plain
        got = fn(torch.from_numpy(flat), torch.from_numpy(row0), window=window,
                 out_cols=out_cols)
        np.testing.assert_array_equal(got.numpy(), want[:, :, :oc])


def _sequences(seed=2, lengths=(23, 40, 9)):
    rng = np.random.default_rng(seed)
    p2 = [rng.standard_normal((n, 17, 2)).astype(np.float32) for n in lengths]
    p3 = [rng.standard_normal((n, 17, 3)).astype(np.float32) for n in lengths]
    return p2, p3


def _flip_perm():
    perm = np.arange(17)
    perm[H36M_KPS_LEFT] = H36M_KPS_RIGHT
    perm[H36M_KPS_RIGHT] = H36M_KPS_LEFT
    return perm


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("pad,causal_shift", [(13, 0), (4, 4)])
def test_batch_assembly_matches_jax(augment, pad, causal_shift):
    p2, p3 = _sequences()
    perm = _flip_perm()
    margins = jgen.FlatSequenceDataset.training_margins(pad, causal_shift, 1)
    assert tgen.FlatSequenceDataset.training_margins(pad, causal_shift, 1) == margins
    flip_perms = (perm, perm) if augment else None
    jdev = jgen.FlatSequenceDataset(p2, p3, margins=margins, flip_perms=flip_perms
                                    ).to_device(flatten_2d=augment)
    tds = tgen.FlatSequenceDataset(p2, p3, margins=margins, flip_perms=flip_perms)
    tdev = tds.to_device(torch.device("cpu"))
    sampler = tgen.ChunkedPairSampler([len(s) for s in p2], 16, 1, augment=augment)
    for meta, _ in sampler.next_epoch():
        _, want_3d, want_2d = jgen.assemble_chunked_batch_contiguous(
            jdev.flat_2d_padded, jdev.flat_3d_padded, None, jdev.base_2d, jdev.base_3d,
            jnp.asarray(meta), pad=pad, causal_shift=causal_shift, chunk_length=1,
            kps_flip_perm=tuple(perm), joints_flip_perm=tuple(perm),
            aug_offset_2d=jdev.aug_offset_2d, aug_offset_3d=jdev.aug_offset_3d,
            cols_2d=jdev.cols_2d or 0)
        cam, got_3d, got_2d = tgen.assemble_chunked_batch_contiguous(
            tdev, meta, pad=pad, causal_shift=causal_shift, chunk_length=1)
        assert cam is None
        want_2d = np.asarray(want_2d).reshape(got_2d.shape)  # (B, win, 17*2)
        np.testing.assert_array_equal(got_2d.numpy(), want_2d)
        np.testing.assert_array_equal(got_3d.numpy(), np.asarray(want_3d))
    assert bool(augment) == bool(tdev.aug_offset_2d)


def test_flipped_chunks_need_the_baked_copy():
    p2, p3 = _sequences()
    dev = tgen.FlatSequenceDataset(p2, p3, margins=(4, 4, 0, 0)).to_device("cpu")
    meta = np.asarray([[0, 3, 4, 1]], np.int32)
    with pytest.raises(ValueError, match="baked flipped copy"):
        tgen.assemble_chunked_batch_contiguous(dev, meta, pad=4, causal_shift=0,
                                               chunk_length=1)


@pytest.mark.parametrize("batch,augment", [(16, True), (7, False), (200, True)])
def test_sampler_matches_jax(batch, augment):
    lengths = [23, 40, 9, 1]
    jsamp = jgen.ChunkedPairSampler(lengths, batch, 1, augment=augment, use_native=False)
    tsamp = tgen.ChunkedPairSampler(lengths, batch, 1, augment=augment)
    assert tsamp.num_frames() == jsamp.num_frames()

    def epochs(sampler, n):
        return [(m.copy(), nv) for _ in range(n) for m, nv in sampler.next_epoch()]

    want, got = epochs(jsamp, 2), epochs(tsamp, 2)
    assert len(got) == len(want)
    for (gm, gn), (wm, wn) in zip(got, want):
        assert gm.dtype == np.int32 and gn == wn
        np.testing.assert_array_equal(gm, wm)
    # The final partial batch is padded with copies of its first row.
    partial = [(m, nv) for m, nv in got if nv < batch]
    assert partial and all((m[nv:] == m[0]).all() for m, nv in partial)
    # A restored RNG state replays the same permutation.
    state = tsamp.random_state()
    first = epochs(tsamp, 1)
    tsamp.set_random_state(state)
    jsamp.set_random_state(state)
    for (gm, _), (rm, _), (wm, _) in zip(epochs(tsamp, 1), first, epochs(jsamp, 1)):
        np.testing.assert_array_equal(gm, rm)
        np.testing.assert_array_equal(gm, wm)
