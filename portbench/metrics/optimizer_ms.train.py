"""optimizer_ms.train: device time of the optimizer's kernels a step, in ms
(``torch.profiler``, over the traced steps): the fused AdamW of
``make_optimizer(..., fused=True)``, row 15's one launch a step. Moves
``train_img_per_s``.
"""

from portbench.trace import names_matcher

KERNELS = ("adam_multi_kernel",)


def read(ctx):
    if ctx.profile is None:
        return None
    spent = ctx.profile.seconds_of(names_matcher(KERNELS))
    if spent <= 0.0:
        return None
    return 1e3 * spent / ctx.profile.iters
