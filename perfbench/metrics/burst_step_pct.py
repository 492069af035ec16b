"""Share of the window's decode steps that ran as CUDA-graph replays inside
a burst (``backend.stats["graph_replays"]`` over ``engine.stats
["decode_steps"]``).  The rest are eager single steps, run while a wave
still prefills."""

NAME, UNIT, LAYER, MOVES = "burst_step_pct", "%", "engine", "output_tok_s"


def read(ctx):
    steps = ctx.counters.get("decode_steps", 0)
    if not steps:
        return None
    return 100.0 * ctx.counters["graph_replays"] / steps
