"""launches.infer, launches.train: device activities (kernels, copies and
fills) a request or a step, from ``torch.profiler`` over the traced
iterations: the host's dispatch work. Moves the cell's images/s.
"""


def read(ctx):
    if ctx.profile is None:
        return None
    return ctx.profile.count() / ctx.profile.iters
