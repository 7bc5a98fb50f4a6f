"""mfu.infer, mfu.train: the model's FLOPs a second over the card's bf16
peak, in %.

FLOPs are 2 × the forward's multiply-accumulates per image
(``arith.<family>.macs_per_image``) in a served request, and 6 × in a
train step (the backward at twice the forward), for each image of the
measured window (the traced run's window, before the profiler starts),
over the window's seconds and 989 TFLOP/s. Moves the cell's images/s.
"""

from portbench.arith.roofline import PEAK_FLOPS


def read(ctx):
    flops_per_mac = 6 if ctx.train else 2
    flops = flops_per_mac * ctx.arith.macs_per_image(ctx.model_cfg) * ctx.items
    return 100.0 * flops / ctx.window_s / PEAK_FLOPS["bfloat16"]
