"""Share of the traced stretch in which no kernel, copy or memset ran on
the device (the union of their intervals in the trace)."""

NAME, UNIT, LAYER, MOVES = "idle_pct.decode", "%", "device", "output_tok_s"


def read(ctx):
    if ctx.trace is None or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
