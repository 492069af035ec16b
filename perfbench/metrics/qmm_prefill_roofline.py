"""K5, the int8 weight products (``csrc/qgemm.cu``), at prefill rows: the
least time of the prefill forwards' products in the traced stretch (2
operations a weight a real token at 989 TFLOP/s, or the weights once at
3.35 TB/s, the larger: ``work.prefill_call``), over the device time of
the product kernels launched from the prefill forwards."""

from perfbench import work

NAME, UNIT, LAYER, MOVES = "qmm_prefill_roofline", "%", "kernels", "ttft_p95_ms"
KERNELS = ("qgemm_wgmma_kernel", "reduce_out_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    bound = 0.0
    for call in ctx.calls:
        if call["kind"] == "prefill":
            w = work.prefill_call(ctx.cfg, call["prompt_lens"])
            bound += work.bound_seconds(w["products"], w["weight_bytes"])
    seconds = ctx.trace.device_seconds(KERNELS, ctx.PREFILL_SPANS)
    return 100.0 * bound / seconds if seconds and bound else None
