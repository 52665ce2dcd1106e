"""stream.enqueue_ms: host ms from the call of ``StreamingCausalLifter.step`` to
its return, without a synchronise, averaged over the untraced window's
dispatches (a benchmark span)."""


def read(ctx):
    return ctx["window"]["enqueue_ms"]
