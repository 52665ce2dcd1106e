"""eval.useful_frame_pct: the share of the output frames computed that are a
video's own, over the traced stretch: the program's counters ``eval.frames``
(valid frames) over ``eval.frames_computed`` (each row's output frames, the
batcher's bucket padding included)."""

from perfbench import spans


def read(ctx):
    c = spans.counters()
    if not c.get("eval.frames_computed"):
        return None
    return 100.0 * c["eval.frames"] / c["eval.frames_computed"]
