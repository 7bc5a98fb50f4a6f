"""kernel_ms.infer, kernel_ms.train: device time of the kernels a request
or a step, in ms: every device activity of the traced iterations but the
memory copies and fills (``torch.profiler``). The device's own work,
steadier from run to run than the cell's host-clock rate (which the host's
copy speed moves). Moves the cell's images/s.
"""

COPIES = ("Memcpy", "Memset")


def read(ctx):
    if ctx.profile is None:
        return None
    spent = ctx.profile.seconds_of(lambda name: not name.startswith(COPIES))
    return 1e3 * spent / ctx.profile.iters
