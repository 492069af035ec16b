"""Share of the window's eager decode steps, those outside bursts
(``engine.stats["decode_steps"]`` less ``backend.stats["graph_replays"]``),
that ran as a replay of the single step's CUDA graph (``backend.stats
["step_replays"]``).  None where the program keeps no such counter."""

NAME, UNIT, LAYER, MOVES = "step_graph_pct", "%", "model step", "output_tok_s"


def read(ctx):
    counters = ctx.counters
    if "step_replays" not in counters:
        return None
    eager = counters.get("decode_steps", 0) - counters.get("graph_replays", 0)
    if eager <= 0:
        return None
    return 100.0 * counters["step_replays"] / eager
