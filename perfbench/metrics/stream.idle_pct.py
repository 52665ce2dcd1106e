"""stream.idle_pct: the share of the traced stretch in which no kernel, copy or memset
ran on the card."""


def read(ctx):
    t = ctx["traced"]["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
