"""K5/K6, the int8 weight products (``csrc/qgemm.cu`` and its stream-K
reduction), at decode rows: their least time over the decode steps of the
traced stretch (``work.qmm_decode_step``: every int8 product of a step,
each expert's stack included, since a batch's tokens reach every expert,
at 3.35 TB/s), over the device time of the product kernels launched from
those steps."""

from perfbench import work

NAME, UNIT, LAYER, MOVES = "qmm_decode_roofline", "%", "kernels", "output_tok_s"
KERNELS = ("qgemm_wgmma_kernel", "reduce_out_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    bound = 0.0
    for call in ctx.calls:
        for lengths in call.get("steps", ()):
            w = work.qmm_decode_step(ctx.cfg, len(lengths))
            bound += work.bound_seconds(w["flops"], w["bytes"])
    seconds = ctx.trace.device_seconds(KERNELS, ctx.DECODE_SPANS)
    return 100.0 * bound / seconds if seconds and bound else None
