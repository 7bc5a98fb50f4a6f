"""h2d_ms.infer, h2d_ms.train: device time of host-to-device copies a
request or a step, in ms (``torch.profiler``'s memcpy activities, over the
traced iterations). Moves the cell's images/s.
"""


def read(ctx):
    if ctx.profile is None:
        return None
    spent = ctx.profile.seconds_of(lambda name: "HtoD" in name)
    return 1e3 * spent / ctx.profile.iters
