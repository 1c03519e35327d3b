"""Share of the traced window in which no operation ran on the card."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / ctx["window_s"])
