"""K9, the fused decode layer (``csrc/megastep.cu`` over ``csrc/tail.cu``):
its least time over the decode steps of the traced stretch, eager and in
bursts (``work.k9_step``: the tail's and next QKV's int8 weights and the
cache rows at 3.35 TB/s, or the operations at 989 TFLOP/s), over the
device time of its kernels launched from those steps.  The stream-K
reduction kernel is shared with K5/K6, whose two launches a step (layer
0's QKV, the LM head) are counted in with it."""

from perfbench import work

NAME, UNIT, LAYER, MOVES = "k9_roofline", "%", "kernels", "output_tok_s"
KERNELS = ("attn_kernel", "tail_gemm_kernel", "reduce_out_kernel", "swiglu_kernel",
           "residual_norm_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    bound = 0.0
    for call in ctx.calls:
        for lengths in call.get("steps", ()):
            w = work.k9_step(ctx.cfg, lengths)
            bound += work.bound_seconds(w["flops"], w["bytes"])
    seconds = ctx.trace.device_seconds(KERNELS, ctx.DECODE_SPANS)
    return 100.0 * bound / seconds if seconds and bound else None
