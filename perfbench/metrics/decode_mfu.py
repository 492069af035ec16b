"""The whole decode step's share of the card's peak: for each burst step of
the traced stretch the larger of its bytes at 3.35 TB/s (every int8 weight,
the LM head, the cache rows each slot attends to) and its operations at
989 TFLOP/s (``work.decode_step``), summed, over the bursts' host time
(each burst ends in a host fetch, so its time is the device's)."""

from perfbench import work

NAME, UNIT, LAYER, MOVES = "decode_mfu", "%", "model step", "output_tok_s"


def read(ctx):
    bound = host = 0.0
    for call in ctx.calls:
        if call["kind"] != "burst":
            continue
        host += call["host_s"]
        for lengths in call["steps"]:
            w = work.decode_step(ctx.cfg, lengths)
            bound += work.bound_seconds(w["flops"], w["bytes"])
    return 100.0 * bound / host if host else None
