"""Model operations of the prompts prefilled in the traced stretch (the
products at every real token, the LM head at each prompt's last one, the
windowed causal attention: ``work.prefill_call``) over the prefill
forwards' host time times 989 TFLOP/s.  Each forward is timed to a
synchronise; the engine's sampling right after it synchronises too."""

from perfbench import work

NAME, UNIT, LAYER, MOVES = "prefill_mfu", "%", "model step", "ttft_p95_ms"


def read(ctx):
    flops = host = 0.0
    for call in ctx.calls:
        if call["kind"] == "prefill":
            flops += work.prefill_call(ctx.cfg, call["prompt_lens"])["flops"]
            host += call["host_s"]
    return 100.0 * flops / (host * work.BF16_FLOPS) if host else None
