"""``data/generators.assemble_chunked_batch``, the seq-bounds batcher over
streams concatenated without margins, bitwise against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopose3d_tpu.data.generators import assemble_chunked_batch as jax_assemble
from videopose3d_torch.data.generators import assemble_chunked_batch

KPS_PERM = (0, 4, 5, 6, 1, 2, 3, 7, 8, 9, 10, 14, 15, 16, 11, 12, 13)


@pytest.mark.parametrize("with_3d,with_cameras", [(True, True), (True, False),
                                                 (False, False), (False, True)])
@pytest.mark.parametrize("causal", [False, True], ids=["centred", "causal"])
def test_matches_jax_bitwise(causal, with_3d, with_cameras):
    rng = np.random.default_rng(int(causal) * 4 + 2 * with_3d + with_cameras)
    lengths = [5, 40, 17, 1, 29]
    bounds = np.cumsum([0] + lengths)
    seq_bounds = np.stack([bounds[:-1], bounds[1:]], axis=1).astype(np.int32)
    flat_2d = rng.standard_normal((bounds[-1], 17, 2)).astype(np.float32)
    flat_3d = rng.standard_normal((bounds[-1], 17, 3)).astype(np.float32)
    cameras = rng.standard_normal((len(lengths), 9)).astype(np.float32)
    chunk, pad = 3, 4
    seq = rng.integers(0, len(lengths), 64)
    # Starts before the sequence's first frame and ends past its last: clamped.
    start = rng.integers(-chunk - 2, np.asarray(lengths)[seq] + 2)
    meta = np.stack([seq, start, start + chunk, rng.integers(0, 2, 64)],
                    axis=1).astype(np.int32)
    kw = dict(pad=pad, causal_shift=pad if causal else 0, chunk_length=chunk,
              kps_flip_perm=KPS_PERM, joints_flip_perm=KPS_PERM, with_3d=with_3d,
              with_cameras=with_cameras)
    want = jax_assemble(jnp.asarray(flat_2d), jnp.asarray(flat_3d), jnp.asarray(cameras),
                        jnp.asarray(seq_bounds), jnp.asarray(meta), **kw)
    got = assemble_chunked_batch(torch.from_numpy(flat_2d), torch.from_numpy(flat_3d),
                                 torch.from_numpy(cameras), seq_bounds, meta, **kw)
    assert (got[0] is None) == (not with_cameras) and (got[1] is None) == (not with_3d)
    assert got[2].shape == (64, chunk + 2 * pad, 17, 2)
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The clamp: a window row before a sequence's start repeats its first frame.
    row = int(np.argmin(meta[:, 1]))
    if not meta[row, 3]:
        lo = seq_bounds[meta[row, 0], 0]
        np.testing.assert_array_equal(got[2][row, 0].numpy(), flat_2d[lo])
