"""idle_share.infer, idle_share.train: the share of the time in which no
kernel and no copy ran on the device, in %.

Served requests: over the traced window (``torch.profiler`` with device
activities alone, one stream; the window runs from the first traced
activity's start to the last one's end). Train steps: one minus the traced
device time a step over the measured window's seconds a step, since a step
of some thousand launches still runs slower under the profiler (each launch
is recorded) and its traced window would count that as idle. A request's
device time swings with its copy from the host, so four traced requests
stand for the window's less well, and the traced window serves there.
Moves the cell's images/s.
"""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    if ctx.train:
        seconds_a_step = ctx.window_s * ctx.batch / ctx.items
        return 100.0 * (1.0 - p.busy_s() / p.iters / seconds_a_step)
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
