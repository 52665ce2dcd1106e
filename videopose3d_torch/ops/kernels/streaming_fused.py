"""The fused streaming step: every residual block and the shrink for one frame
(K5) or k frames (K6) of B streams in one kernel, the in-place ring push (K7), the
streaming front (F: the frame into the raw ring and the int8 expand) and the
rings' advance on the card, and their plain PyTorch versions.

Counterpart of ``videopose3d_tpu/ops/pallas/streaming_fused.py`` and of
``_ring_push_dma`` in ``videopose3d_tpu/streaming.py``.  The plain versions follow
the JAX kernels' math row by row, not their TPU scheduling (row chunks, skewed
pipelines, VMEM budgets, timing experiments): those are bit-identical there.

Rings are time-major ``(cap, B, C)`` tensors, or ``(2 * cap, B, C)`` doubled rings
for k frames per step.  They are updated **in place** (the JAX package donates
them) and returned.  ``idx`` holds, per residual block, ``[write_slot,
tap_slot, ...]`` with the older taps oldest first, blocks concatenated, as host
ints: the kernel takes them by value.  Tap j's slot is the ring row of the first
frame's tap; with k frames, frame f's tap is row ``slot + f`` after the push.  The
per-frame int8 step may take its slots from ``pos`` instead, an int32 tensor of
the rings' positions (the raw ring's, then one per block) that stays on the card:
F and K5 read it, :func:`ring_advance` moves it on, and the host passes nothing
that changes from one frame to the next, so the three replay as one CUDA graph.

Dispatch: tensors on the CPU take the ``*_plain`` version; CUDA tensors launch
the kernel (``csrc/stream_int8.cu`` and ``csrc/stream_bf16.cu``: the steps on the
tensor cores, through ``csrc/streaming_fused.cu``; the ring push there) or raise.
``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence

import torch

from videopose3d_torch.ops.kernels.build import check, launch, sm_count
from videopose3d_torch.ops.kernels.temporal_block import SMEM_OPT_IN
from videopose3d_torch.ops.kernels.temporal_block_int8 import QMAX, _i8mm, _rdiv, _to_stream

LAUNCHES = {"stream_int8": 0, "stream_bf16": 0, "stream_int8_multi": 0,
            "stream_bf16_multi": 0, "ring_push": 0, "stream_front": 0, "ring_advance": 0}

_ACT_TYPE = {"int8": 0, "bf16": 1}


def pack_vec_rows(rows):
    """Stack per-channel epilogue vectors into one (8, C) float32 tensor, zero
    rows after them (the JAX package's operand layout)."""
    v = torch.stack([torch.as_tensor(r, dtype=torch.float32).reshape(-1) for r in rows])
    return torch.nn.functional.pad(v, (0, 0, 0, 8 - v.shape[0])).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def ring_push_plain(buf, slot: int, row):
    """Write ``row`` (B, C) into ``buf`` (cap, B, C) at ``slot``, in place."""
    buf[slot].copy_(row)
    return buf


def _push(ring, write: int, x, cap: int, doubled: bool):
    """Write the (k, B, C) block x at ``write`` (and ``write + cap``), in place."""
    k = x.shape[0]
    ring[write: write + k] = x
    if doubled:
        ring[write + cap: write + cap + k] = x


def _split(idx: Sequence[int], widths):
    """Per block (write_slot, [tap slots]) from the flat index list."""
    out, off = [], 0
    for w in widths:
        out.append((int(idx[off]), [int(t) for t in idx[off + 1: off + w]]))
        off += w
    return out


def stream_front_plain(rows, ring, pos: int, w0, s0, b0):
    """Plain version of :func:`stream_front`: bf16(rows) (B, C_in) pushed into the
    raw ring (cap, B, C_in) at ``pos``, in place; the expand conv's cap taps, the
    older frames from the ring oldest first, then the frame; and the expand as
    ``streaming._expand_step_i8``: the bf16 products summed in float64, rounded once
    to float32, then clip(rint(relu(v * s0 + b0)), 0, 127).  Returns the (B, C) int8
    expand stream."""
    cap = ring.shape[0]
    x = rows.to(torch.bfloat16)
    _push(ring, pos, x[None], cap, False)
    taps = torch.cat([ring[(pos - lag) % cap] for lag in range(cap - 1, 0, -1)] + [x], -1)
    eacc = (taps.double() @ w0.double()).float()
    return _to_stream(torch.relu(eacc * s0 + b0))


def _ring_slot(pos, lag: int, cap: int):
    """(pos - lag) mod cap as the kernels take it (``ring_slot``,
    csrc/stream_step.cuh): C's truncating remainder, then cap added to a negative
    one."""
    s = torch.fmod(pos - lag, cap)
    return torch.where(s < 0, s + cap, s)


def device_slots_plain(pos, caps, lags):
    """The slots K5 derives from the positions on the card: ``pos`` the int32
    positions (the raw ring's, then one per block), ``caps`` and ``lags`` per
    residual block.  Returns per block ``[write_slot, tap_slot, ...]``, concatenated,
    as ``streaming._slots`` gives them from the host's positions."""
    idx = []
    for i, (cap, block_lags) in enumerate(zip(caps, lags)):
        idx += [int(_ring_slot(pos[1 + i], lag, cap)) for lag in [0, *block_lags]]
    return idx


def ring_advance_plain(pos, caps):
    """Plain version of :func:`ring_advance`: each position one frame on, modulo its
    ring's capacity, in place."""
    caps = torch.as_tensor(caps, dtype=pos.dtype, device=pos.device)
    pos.copy_(_ring_slot(pos + 1, 0, caps))
    return pos


def block_step_i8(blk, tap_rows, newest_q, *, last: bool):
    """One w8a8 residual block on (rows, C) int8 tap rows, oldest first, the newest
    (the block's input ``newest_q``) last: the int8 output stream, or for the last
    block its float32 output.  The operations of ``temporal_block_int8._block_body``
    in its order; each tap is contracted against its own weight slice (int32 sums
    commute)."""
    acc = _i8mm(tap_rows[0], blk.wq_a[0])
    for j in range(1, len(tap_rows)):
        acc = acc + _i8mm(tap_rows[j], blk.wq_a[j])
    real = torch.relu(acc.float() * blk.A1 + blk.B1)
    rowmax = torch.clamp_min(real.amax(dim=-1, keepdim=True), 1.0)
    hq = torch.round(real * _rdiv(QMAX, rowmax)).to(torch.int8)
    y = torch.relu(_i8mm(hq, blk.wq_b).float() * (rowmax * (1.0 / QMAX)) * blk.A2 + blk.B2)
    out = newest_q.float() * blk.R + y
    return out if last else _to_stream(out)


def blocks_int8_plain(q, rings, eq, idx, widths, caps, doubled: bool):
    """Every int8 residual block and the shrink on (k, B, C) int8 ``eq``; pushes
    each block's input, then reads its taps as (k, B, C) slabs of the ring.
    Returns (k*B, J3) float32 poses, frame-major."""
    k, b, c = eq.shape
    act = eq.reshape(k * b, c)
    out = None
    for i, (write, taps) in enumerate(_split(idx, widths)):
        _push(rings[i], write, act.reshape(k, b, c), caps[i] if doubled else 0, doubled)
        rows = [rings[i][t: t + k].reshape(k * b, c) for t in taps] + [act]
        last = i == len(widths) - 1
        result = block_step_i8(q.blocks[i], rows, act, last=last)
        if last:
            out = result
        else:
            act = result
    return out.to(torch.bfloat16).float() @ q.shrink_w.float() + q.shrink_b


def blocks_float_plain(w, rings, a0, idx, widths, caps, doubled: bool, dt, push=None):
    """Every residual block and the shrink on the (k, B, C) float32 activation
    ``a0`` at activation dtype ``dt`` (the rings hold ``act`` cast to ``dt``; a
    product of ``dt`` values is summed in float32).  ``push(ring, write, x)``
    replaces the plain ring write for single rings (K7).  Returns (k*B, J3)
    float32 poses, frame-major."""
    k, b, c = a0.shape
    act = a0.reshape(k * b, c).float()
    for i, (write, taps) in enumerate(_split(idx, widths)):
        act_c = act.to(dt)
        if push is None:
            _push(rings[i], write, act_c.reshape(k, b, c), caps[i] if doubled else 0,
                  doubled)
        else:
            push(rings[i], write, act_c)
        w1, w2, vecs = w["w1"][i], w["w2"][i], w["vecs"][i]
        rows = [rings[i][t: t + k].reshape(k * b, c) for t in taps] + [act_c]
        h = rows[0].float() @ w1[0].float()
        for j in range(1, len(rows)):
            h = h + rows[j].float() @ w1[j].float()
        h = torch.relu(h * vecs[0] + vecs[1]).to(dt)
        z = h.float() @ w2.float()
        act = act + torch.relu(z * vecs[2] + vecs[3])
    return act.to(dt).float() @ w["shrink_w"].float() + w["shrink_b"]


def fused_blocks_step_plain(w, rings, eq, idx, *, widths):
    """Plain version of :func:`fused_blocks_step`."""
    poses = blocks_int8_plain(w.q, rings, eq[None], idx, widths, None, doubled=False)
    return poses, rings


def fused_blocks_step_multi_plain(w, rings, eq, idx, *, widths, lags, caps, k):
    """Plain version of :func:`fused_blocks_step_multi` (``lags``, of the JAX
    signature, is not needed: the push-then-read reads every tap from the ring)."""
    return blocks_int8_plain(w.q, rings, eq, idx, widths, caps, doubled=True), rings


def fused_blocks_step_bf16_plain(weights, rings, a0, idx, *, widths):
    """Plain version of :func:`fused_blocks_step_bf16`."""
    poses = blocks_float_plain(weights, rings, a0[None], idx, widths, None, False,
                               torch.bfloat16)
    return poses, rings


def fused_blocks_step_bf16_multi_plain(weights, rings, a0, idx, *, widths, lags, caps, k):
    """Plain version of :func:`fused_blocks_step_bf16_multi`."""
    poses = blocks_float_plain(weights, rings, a0, idx, widths, caps, True, torch.bfloat16)
    return poses, rings


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# The step kernels' limits (csrc/stream_step.cuh): at most MAX_BLOCKS residual
# blocks of MAX_TAPS older taps each, 1 to MAX_FRAMES frames per step.
MAX_BLOCKS, MAX_TAPS, MAX_FRAMES = 8, 8, 16

# The tensor-core geometry of both step kernels (csrc/stream_bf16.cu, and
# csrc/stream_tc.cuh for the int8 step): rows per CUDA block, output columns per
# pass, bytes of one K-tile stage of a warp group's cp.async ring (A: rows x 80
# bytes; B: 8,704 bytes) and the ring's depth, warp groups per CUDA block, the
# shared-memory ints (row offsets and 16 tap slots), and the most column slices per
# cluster; the K-tile depth in elements of each kind, and the int8 step's cost of
# its cluster's meetings in K-tile rows per doubling of the cluster (fitted to
# kernel_ab.py --sweep stream_int8 on an H100; PERF.md).
TC_ROWS = tuple(range(16, 81, 16))
TC_NP, TC_STAGES, TC_GROUPS, TC_SLOT_INTS, TC_MAX_SLICES = 128, 4, 2, 16, 8
BF16_BK, INT8_BK = 32, 64
INT8_MEET = 352


def _slice_cols(c: int, n: int) -> int:
    """Columns each block of an n-block cluster owns: ceil(c / n) rounded up to 8."""
    return (-(-c // n) + 7) // 8 * 8


def _rings_bytes(rows: int) -> int:
    """Both warp groups' cp.async rings of K-tile stages."""
    return TC_GROUPS * TC_STAGES * (rows * 80 + 8704)


def bf16_smem_bytes(rows: int, slices: int, c: int) -> int:
    """Shared memory of one CUDA block of the bf16 step at plan (rows, slices)
    (``vp3d_stream_bf16_smem``): the float32 carry slice, the row offsets and tap
    slots, and the warp groups' rings."""
    return rows * _slice_cols(c, slices) * 4 + (rows + TC_SLOT_INTS) * 4 + _rings_bytes(rows)


def int8_smem_bytes(rows: int, slices: int, c: int) -> int:
    """Shared memory of one CUDA block of the int8 step at plan (rows, slices)
    (``vp3d_stream_int8_smem``): the float32 real slice and the int8 carry slice,
    three float32 row vectors (maxima, 127 / m, m / 127), the row offsets and tap
    slots, and the warp groups' rings."""
    return (rows * _slice_cols(c, slices) * 5 + (4 * rows + TC_SLOT_INTS) * 4
            + _rings_bytes(rows))


def _max_slices(c: int) -> int:
    """The most column slices (a power of two up to TC_MAX_SLICES) that leave
    every block of the cluster at least one of the c columns."""
    best, n = 1, 2
    while n <= TC_MAX_SLICES:
        if (n - 1) * _slice_cols(c, n) < c:
            best = n
        n *= 2
    return best


def step_smem_bytes(int8: bool, c: int) -> int:
    """Shared memory of one CUDA block of the step's smallest plan (16 rows, the
    most column slices) at c channels (``vp3d_stream_smem_bytes``): c fits if this
    does."""
    return (int8_smem_bytes if int8 else bf16_smem_bytes)(16, _max_slices(c), c)


def _max_channels(smem) -> int:
    """The widest C a step takes: its smallest plan's slices (16 rows x C / 8
    columns; ``smem(16, 8, 64) - smem(16, 8, 0)`` bytes per 8 columns of a slice)
    and fixed shared memory within SMEM_OPT_IN."""
    fixed = smem(16, TC_MAX_SLICES, 0)
    per8 = smem(16, TC_MAX_SLICES, 8 * TC_MAX_SLICES) - fixed
    return (SMEM_OPT_IN - fixed) // per8 * 8 * TC_MAX_SLICES


BF16_MAX_CHANNELS = _max_channels(bf16_smem_bytes)
INT8_MAX_CHANNELS = _max_channels(int8_smem_bytes)


def _plan_valid(smem, rows: int, slices: int, k: int, c: int) -> bool:
    """Whether plan (rows, slices) takes k frames and c channels within the
    shared memory ``smem(rows, slices, c)``."""
    return rows >= k and slices <= _max_slices(c) and smem(rows, slices, c) <= SMEM_OPT_IN


def _plan_cost(rows: int, slices: int, b: int, k: int, c: int, sms: int, bk: int,
               meet: int) -> int:
    """One C x C product's cost at plan (rows, slices), K tiles ``bk`` deep: each
    block's K tiles per 128-column pass, weighted by the rows of A and B they load,
    plus ``meet`` K-tile rows per doubling of the cluster (the int8 step's cluster
    meets within a residual block, each meeting waiting for its slowest block),
    times the waves of clusters (one CUDA block per SM; a cluster of 4 or 8 fits in
    120 of an H100's 132 SMs) plus the blocks' share of the SMs (the L2 they share
    slows each block as more SMs load at once); in units of K-tile rows / sms."""
    tiles = -(-b // (rows // k))
    passes = -(-_slice_cols(c, slices) // TC_NP)
    usable = sms * 120 // 132 if slices >= 4 else sms
    per_wave = max(1, usable // slices)
    per_block = passes * -(-c // bk) * (rows + 32) + meet * slices.bit_length()
    return per_block * (-(-tiles // per_wave) * sms + tiles * slices)


def _plan(smem, bk: int, meet: int, b: int, k: int, c: int, sms: int):
    """The cheapest valid plan (rows, slices) under the cost model, fewest rows
    then fewest slices among equals; None when no plan fits."""
    best = None
    for rows in TC_ROWS:
        n = 1
        while n <= TC_MAX_SLICES:
            if _plan_valid(smem, rows, n, k, c):
                cost = _plan_cost(rows, n, b, k, c, sms, bk, meet)
                if best is None or cost < best[0]:
                    best = (cost, rows, n)
            n *= 2
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=None)
def stream_bf16_plan(b: int, k: int, c: int, sms: int = 132):
    """The plan the bf16 step launches with for ``b`` streams of ``k`` frames at
    ``c`` channels on ``sms`` SMs: (rows per CUDA block, column slices per
    cluster); None past BF16_MAX_CHANNELS.  Made once per shape; the kernel only
    checks it (``plan_valid``, csrc/stream_bf16.cu)."""
    return _plan(bf16_smem_bytes, BF16_BK, 0, b, k, c, sms)


@functools.lru_cache(maxsize=None)
def stream_int8_plan(b: int, k: int, c: int, sms: int = 132):
    """The int8 step's plan, as :func:`stream_bf16_plan` over its own shared
    memory, 64-deep K tiles and the cost of its cluster's meetings; None past
    INT8_MAX_CHANNELS."""
    return _plan(int8_smem_bytes, INT8_BK, INT8_MEET, b, k, c, sms)


def step_limit_error(engine: str, c: int, widths, k: int):
    """Why the fused streaming step (K5, K6 at k > 1) cannot serve ``engine``
    (``int8_fused`` or ``bf16_fused``) at ``c`` channels, residual blocks of
    filter ``widths`` and ``k`` frames per step, or None; known without the card."""
    per_layer = engine.replace("_fused", "")
    what = f"the fused streaming kernel (--engine {engine} on CUDA)"
    use = f"; use --engine {per_layer}"
    if not 1 <= k <= MAX_FRAMES:
        return f"--frames-per-step {k}: {what} takes 1 to {MAX_FRAMES} frames per step{use}"
    if not 1 <= len(widths) <= MAX_BLOCKS or any(not 1 <= w <= MAX_TAPS + 1
                                                 for w in widths):
        return (f"residual blocks of filter widths {tuple(widths)}: {what} takes 1 to "
                f"{MAX_BLOCKS} blocks of at most {MAX_TAPS + 1} taps{use}")
    if engine == "int8_fused" and c > INT8_MAX_CHANNELS:
        return (f"{c} channels: {what} takes at most {INT8_MAX_CHANNELS} channels "
                f"(its float32 and int8 slices in shared memory){use}")
    if engine != "int8_fused" and c > BF16_MAX_CHANNELS:
        return (f"{c} channels: {what} takes at most {BF16_MAX_CHANNELS} channels "
                f"(its float32 carry slice in shared memory){use}")
    return None


@dataclasses.dataclass
class Int8StepWeights:
    """The fused int8 step's weights: the ``QuantizedModel`` ``q`` (its expand, and
    its blocks and shrink for the plain version) and ``packs``, per residual block
    (wq_a packed per tap, wq_b packed) by ``temporal_block_int8.pack_int8_step``,
    the kernel's: the packs each ``Int8Block`` made once for the int8 kernels."""

    q: object
    packs: list = dataclasses.field(repr=False)

    @classmethod
    def of(cls, q):
        """``q``'s weights for the step: its blocks' packs."""
        return cls(q, [(blk.pa, blk.pb) for blk in q.blocks])


def _launch(kind, x, blocks, rings, idx, widths, caps, k, doubled, ws, bs, pos=None,
            lags=None):
    """Check every operand against the kernel's contract and launch the step.
    ``blocks`` holds per residual block (wa, wb, [epilogue vectors]).  With ``pos``
    (the per-frame int8 step only) the kernel derives every slot from the positions
    on the card and the per-block ``lags``; ``idx`` is then not read."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the {kind} kernel runs on CUDA tensors, got {dev}")
    n = len(widths)
    kk, b, c = x.shape
    if kk != k:
        raise ValueError(f"the input holds {kk} frames, the step {k}")
    int8 = kind.startswith("stream_int8")
    err = step_limit_error("int8_fused" if int8 else "bf16_fused", c, widths, k)
    if err:
        raise ValueError(err)
    if len(rings) != n or len(blocks) != n:
        raise ValueError(f"the {kind} kernel takes one ring per residual block, got "
                         f"{n} widths and {len(rings)} rings")
    if pos is not None:
        if kind != "stream_int8":
            raise ValueError(f"the {kind} kernel takes its ring positions from the host")
        check("positions", pos, dev, torch.int32, (n + 1,))
        if lags is None or [len(block) for block in lags] != [w - 1 for w in widths]:
            raise ValueError(f"positions on the card need {[w - 1 for w in widths]} older "
                             f"taps' lags per block, got {lags}")
        idx = [0] * sum(widths)
    if len(idx) != sum(widths):
        raise ValueError(f"idx holds {len(idx)} slots, the widths {sum(widths)}")
    # The kernels read aligned rows of the rings, x and the shrink as 16-byte words.
    check("x", x, dev, torch.int8 if int8 else torch.float32, (k, b, c), align=16)
    ring_dt = torch.int8 if int8 else torch.bfloat16
    j3 = ws.shape[1]
    check("shrink_w", ws, dev, torch.bfloat16, (c, j3), align=16)
    check("shrink_b", bs, dev, torch.float32, (j3,))
    kp, np_ = -(-c // 32) * 32, -(-c // 8) * 8
    ptrs: List[int] = []
    ints: List[int] = []
    for i, ((write, taps), (wa, wb, vecs)) in enumerate(zip(_split(idx, widths), blocks)):
        kw = widths[i]
        cap = caps[i] if doubled else rings[i].shape[0]
        check(f"ring {i}", rings[i], dev, ring_dt, ((2 if doubled else 1) * cap, b, c),
              align=16)
        if int8:
            check(f"packed wq_a {i}", wa, dev, torch.int32, (kw, kp // 4, np_), align=16)
            check(f"packed wq_b {i}", wb, dev, torch.int32, (kp // 4, np_), align=16)
        else:
            check(f"w1 {i}", wa, dev, torch.bfloat16, (kw, c, c), align=16)
            check(f"w2 {i}", wb, dev, torch.bfloat16, (c, c), align=16)
        for v, vec in enumerate(vecs):
            check(f"epilogue vector {v} of block {i}", vec, dev, torch.float32, (c,))
        # Slots: a push of k rows at `write` and every tap's k rows must lie in the ring;
        # from positions on the card, every lag must reach back less than the ring holds.
        block_lags = [] if pos is None else list(lags[i])
        if any(not 0 < lag < cap for lag in block_lags):
            raise ValueError(f"ring {i} (cap {cap}): lags {block_lags} out of range")
        if pos is None and (not 0 <= write <= cap - k or any(
                not 0 <= t <= (2 if doubled else 1) * cap - k for t in taps)):
            raise ValueError(f"ring {i} (cap {cap}): slots {write}, {taps} out of range "
                             f"for {k} frame(s)")
        ptrs += [wa.data_ptr(), wb.data_ptr(), *(v.data_ptr() for v in vecs),
                 *([None] * (5 - len(vecs))), rings[i].data_ptr()]
        ints += ([kw, cap, write] + taps + [0] * (MAX_TAPS - len(taps))
                 + block_lags + [0] * (MAX_TAPS - len(block_lags)))
    # The exchange buffer between a cluster's column slices (csrc/stream_step.cuh):
    # bf16, h and the last block's bf16(act); int8, the last block's bf16(v), then hq.
    xbuf = torch.empty(k * b * c * (3 if int8 else 4), dtype=torch.int8, device=dev)
    out = torch.empty((k * b, j3), dtype=torch.float32, device=dev)
    rows, slices = (stream_int8_plan if int8 else stream_bf16_plan)(b, k, c, sm_count(dev))
    launch("vp3d_stream_step", dev, _ACT_TYPE["int8" if int8 else "bf16"], n, b, c, k,
           int(doubled), rows, slices, x, ws, bs, j3, out, xbuf,
           (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints), pos,
           count=(LAUNCHES, kind))
    return out, rings


def _int8_blocks(w, n):
    return [(wa, wb, [blk.A1, blk.B1, blk.A2, blk.B2, blk.R])
            for (wa, wb), blk in zip(w.packs[:n], w.q.blocks[:n])]


def _bf16_blocks(weights, n):
    return [(weights["w1"][i], weights["w2"][i], list(weights["vecs"][i][:4]))
            for i in range(n)]


def fused_blocks_step(w, rings, eq, idx, *, widths, pos=None, lags=None):
    """Every int8 residual block and the shrink on one frame, in one kernel (K5).

    Args:
      w: the :class:`Int8StepWeights` of a ``QuantizedModel``
        (``streaming.prepare_int8_fused``).
      rings: per-block int8 rings (cap_i, B, C), updated in place.
      eq: (B, C) int8 expand stream of this frame (block 0's newest tap).
      idx: per block ``[write_slot, tap_slot, ...]``, host ints; not read with ``pos``.
      widths: per-block filter widths.
      pos: None, or the rings' positions as an int32 tensor on ``eq``'s device (the
        raw ring's, then one per block); the slots are then derived from them and
        ``lags``, per block the older taps' lags, where the kernel runs.

    Returns ((B, J3) float32 poses, rings).
    """
    if eq.device.type == "cpu":
        if pos is not None:
            idx = device_slots_plain(pos, [r.shape[0] for r in rings], lags)
        return fused_blocks_step_plain(w, rings, eq, idx, widths=widths)
    return _launch("stream_int8", eq[None], _int8_blocks(w, len(widths)), rings, idx,
                   widths, None, 1, False, w.q.shrink_w, w.q.shrink_b, pos, lags)


def fused_blocks_step_multi(w, rings, eq, idx, *, widths, lags, caps, k):
    """:func:`fused_blocks_step` on k frames per launch (K6).

    Args:
      rings: per-block int8 doubled rings (2*cap_i, B, C), updated in place.
      eq: (k, B, C) int8 expand stream of this step's frames.
      idx: per block ``[write_slot, tap_start, ...]`` (``write_slot`` k-aligned).
      lags: per block the older taps' lags ``(width-1-j) * dilation`` (the JAX
        signature's; the kernel reads every tap, the step's own frames included,
        from the ring after its push, as the plain version).
      caps: per-block ring capacities (one copy).

    Returns ((k*B, J3) float32 poses, frame-major, rings).
    """
    if eq.device.type == "cpu":
        return fused_blocks_step_multi_plain(w, rings, eq, idx, widths=widths, lags=lags,
                                             caps=caps, k=k)
    return _launch("stream_int8_multi", eq, _int8_blocks(w, len(widths)), rings, idx,
                   widths, caps, k, True, w.q.shrink_w, w.q.shrink_b)


def fused_blocks_step_bf16(weights, rings, a0, idx, *, widths):
    """The bf16 counterpart of :func:`fused_blocks_step` (K5): an f32 residual
    carry, bf16 rings.

    Args:
      weights: from ``streaming.prepare_bf16_fused``: per block ``w1`` (k, C, C)
        and ``w2`` (C, C) bf16, ``vecs`` (8, C) f32 rows [s1, t1, s2, t2]; and
        ``shrink_w`` (C, J3) bf16, ``shrink_b`` (J3,) f32.
      rings: per-block bf16 rings (cap_i, B, C), updated in place.
      a0: (B, C) float32 expand activation of this frame.
    """
    if a0.device.type == "cpu":
        return fused_blocks_step_bf16_plain(weights, rings, a0, idx, widths=widths)
    return _launch("stream_bf16", a0[None], _bf16_blocks(weights, len(widths)), rings,
                   idx, widths, None, 1, False, weights["shrink_w"],
                   weights["shrink_b"])


def fused_blocks_step_bf16_multi(weights, rings, a0, idx, *, widths, lags, caps, k):
    """The bf16 counterpart of :func:`fused_blocks_step_multi` (K6): ``a0`` is the
    (k, B, C) float32 expand activation, ``rings`` bf16 doubled rings."""
    if a0.device.type == "cpu":
        return fused_blocks_step_bf16_multi_plain(weights, rings, a0, idx, widths=widths,
                                                  lags=lags, caps=caps, k=k)
    return _launch("stream_bf16_multi", a0, _bf16_blocks(weights, len(widths)), rings,
                   idx, widths, caps, k, True, weights["shrink_w"],
                   weights["shrink_b"])


def ring_push(buf, slot: int, row):
    """Write ``row`` (B, C) into the (cap, B, C) ring ``buf`` at host int ``slot``,
    in place (K7): one copy kernel, the rest of the ring untouched."""
    if buf.device.type == "cpu":
        return ring_push_plain(buf, slot, row)
    dev = buf.device
    if buf.ndim != 3:
        raise ValueError(f"ring must be (cap, B, C), got {tuple(buf.shape)}")
    cap, b, c = buf.shape
    check("row", row, dev, buf.dtype, (b, c))
    check("ring", buf, dev, buf.dtype, (cap, b, c))
    if not 0 <= slot < cap:
        raise ValueError(f"slot {slot} out of range for a ring of {cap}")
    n_bytes = row.numel() * row.element_size()
    launch("vp3d_ring_push", dev, buf, row, slot * n_bytes, n_bytes,
           count=(LAUNCHES, "ring_push"))
    return buf


def stream_front(rows, ring, pos, w0, s0, b0, eq):
    """The streaming front of a per-frame int8 step (F), one kernel: bf16(rows)
    (B, C_in) into the raw ring (cap, B, C_in) at its position ``pos[0]`` (int32, on
    the card), the expand conv over the ring's cap taps (older frames oldest first,
    the frame last) with ``w0`` (cap * C_in, C) bf16, and ``s0``, ``b0`` (C,) float32,
    into ``eq`` (B, C) int8, as :func:`stream_front_plain`.  Moves no position.
    Returns ``eq``."""
    if rows.device.type == "cpu":
        eq.copy_(stream_front_plain(rows, ring, int(pos[0]), w0, s0, b0))
        return eq
    dev = rows.device
    b, c_in = rows.shape
    cap = ring.shape[0]
    c = eq.shape[1]
    check("frame rows", rows, dev, torch.float32, (b, c_in))
    check("raw ring", ring, dev, torch.bfloat16, (cap, b, c_in))
    check("positions", pos[:1], dev, torch.int32, (1,))
    check("expand weights", w0, dev, torch.bfloat16, (cap * c_in, c))
    check("expand scale", s0, dev, torch.float32, (c,))
    check("expand shift", b0, dev, torch.float32, (c,))
    check("eq", eq, dev, torch.int8, (b, c), align=4)
    launch("vp3d_stream_front", dev, rows, ring, pos, b, c_in, cap, w0, s0, b0, c, eq,
           count=(LAUNCHES, "stream_front"))
    return eq


def ring_advance(pos, caps):
    """Every ring's position ``pos`` (int32, the raw ring's then one per block) one
    frame on, modulo its capacity ``caps``, in place where it lies: one tiny kernel
    on the card.  Returns ``pos``."""
    if pos.device.type == "cpu":
        return ring_advance_plain(pos, caps)
    check("positions", pos, pos.device, torch.int32, (len(caps),))
    launch("vp3d_ring_advance", pos.device, pos, (ctypes.c_int * len(caps))(*caps),
           len(caps), count=(LAUNCHES, "ring_advance"))
    return pos
