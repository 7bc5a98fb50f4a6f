"""window_split_ms.train: device time a train step of the split-head window
path's forward, in ms: everything launched inside the port's span
``vtt.window.split`` (``ops/windows.py``: the q, k, v split into heads, the
grouped fp32 bias, row 2's forward and the reverse into the map), over the
traced steps (``torch.profiler``'s links from host operations to the
device work they launched). Windows of more than 128 tokens take this
path. None where nothing ran inside the span (a tree without it). Moves
``train_img_per_s``.
"""

SPAN = "vtt.window.split"


def read(ctx):
    if ctx.profile is None:
        return None
    spent = ctx.profile.seconds_launched(lambda name: False, (SPAN,))
    if spent <= 0.0:
        return None
    return 1e3 * spent / ctx.profile.iters
