"""bias_bwd_ms.train: device time a train step of the split-head attention's
biased backward, in ms: everything launched inside the port's span
``vtt.attn.bias_bwd`` (``_Flash.backward`` around
``flash_attention_bias_bwd``: the scores and probabilities again, dP, dS,
the three products and the bias gradient's sum, plain PyTorch in fp32),
over the traced steps. None where nothing ran inside the span (a tree
without it). Moves ``train_img_per_s``.
"""

SPAN = "vtt.attn.bias_bwd"


def read(ctx):
    if ctx.profile is None:
        return None
    spent = ctx.profile.seconds_launched(lambda name: False, (SPAN,))
    if spent <= 0.0:
        return None
    return 1e3 * spent / ctx.profile.iters
