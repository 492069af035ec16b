"""K1, the fused attention forward (``csrc/flash_fwd*.cu``), at prefill:
the windowed causal attention of the prompts prefilled in the traced
stretch (the keys each real row sees, ``work.attention_keys``; Q.K^T at
the fp8 peak under fp8 attention, P.V at the bf16 peak), over the device
time of the K1 kernels launched from the prefill forwards."""

from perfbench import work

NAME, UNIT, LAYER, MOVES = "k1_prefill_roofline", "%", "kernels", "ttft_p95_ms"
KERNELS = ("flash_fwd_kernel", "flash_fwd_modes_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    bound = 0.0
    fp8 = ctx.cfg.attention_impl == "fp8"
    for call in ctx.calls:
        if call["kind"] == "prefill":
            w = work.prefill_call(ctx.cfg, call["prompt_lens"])
            bound += work.k1_seconds(w["qk"], w["pv"], fp8_qk=fp8)
    seconds = ctx.trace.device_seconds(KERNELS, ctx.PREFILL_SPANS)
    return 100.0 * bound / seconds if seconds and bound else None
