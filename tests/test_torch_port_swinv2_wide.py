"""SwinV2 with the published per-stage window clip, and windows of more
than 128 tokens, on the CPU.

A tiny ``SwinTransformerV2(clip_window=True)`` whose first two stages
attend 12 × 12 = 144-token windows (above the window kernels' 128, so the
split-head path) and whose last stage's 6 × 6 map is smaller than the
window (clipped to 6 × 6, the batched window path), held against the
benchmark's plain fp32 reference (``portbench/reference/swinv2.py``) on
seeded random weights: logits and every leaf's gradient with stochastic
depth on. Also: each stage's window and shift, the routes, the biased
backward's counters, the two spans under a profiler, the padded geometry
without the argument, and the export → load round trip.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import swinv2 as ref
from portbench.reference.common import block_seeds, cross_entropy
from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformerV2,
)
from vision_transformers_tpu_torch.models.image_classification.swin_transformer import (  # noqa: E501
    clip_to_map,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import windows as tw
from vision_transformers_tpu_torch.utils import metrics

CFG = dict(image_size=48, patch_size=[2, 2], embed_dim=16, depths=[2, 2, 2],
           num_heads=[1, 2, 4], window_size=[12, 12], mlp_ratio=4.0,
           dropout=0.0, attention_dropout=0.0, stochastic_depth_prob=0.3,
           num_classes=10, clip_window=True)
MAPS = (24, 12, 6)
BATCH = 4
# The stage windows and shifts the published rule gives on maps 24, 12, 6
# with window 12: stage 1 shifts by 6, stage 2's window covers its map (no
# shift), stage 3's is clipped to its 6 × 6 map.
PUBLISHED = [((12, 12), (6, 6)), ((12, 12), (0, 0)), ((6, 6), (0, 0))]
# Both sides compute in fp32 with TF32 off; they differ in the order of
# their sums (the port folds the temperature into q and normalises by
# x·rsqrt(Σx² + 1e-12), the reference divides by the norm; the port's
# split-head backward is the JAX formula). Logits agree to ~1e-6 of their
# scale: 1e-4 leaves room for the 4-block depth and flags any change of an
# equation (the unclipped model reads 0.1-1 off, a dropped bias term more).
LOGIT_TOL = 1e-4
# Gradients pass through the same sums backward, the softmax's included:
# each leaf's ‖port − reference‖ within 1e-4 of the larger of its own norm
# and the median leaf's (a leaf whose branch stochastic depth dropped for
# every image has a zero gradient on both sides).
GRAD_TOL = 1e-4


def _weights(seed: int = 20261018):
    """Every leaf drawn as the benchmark draws it (``param_spec``)."""
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randn(shape, generator=gen) * std + mean
            for name, shape, std, mean in ref.param_spec(CFG)}


def _model(**overrides):
    model = SwinTransformerV2(**dict(CFG, **overrides), device="cpu")
    model.load_state_dict(_weights(), strict=True)
    return model


def _batch(seed: int = 5):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(BATCH, 48, 48, 3, generator=gen),
            torch.randint(0, 10, (BATCH,), generator=gen))


def _blocks(model):
    return [getattr(model, n) for n in model.block_names
            if not n.startswith("merge")]


def _port_step(model, x, y, seed):
    """Logits and each leaf's gradient of the mean cross-entropy, in
    training mode, the block seeds drawn from ``seed``."""
    model.train()
    model.dropout_generator.manual_seed(seed)
    logits = model(x)
    loss = cross_entropy(logits, y, torch.ones(BATCH))
    model.zero_grad()
    loss.backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


def _reference_step(x, y, seed, m=CFG):
    params = {k: v.requires_grad_() for k, v in _weights().items()}
    seeds = block_seeds(torch.Generator().manual_seed(seed),
                        ref.seeds_per_forward(m))
    logits = ref.forward(params, x, m, seeds=seeds)
    loss = cross_entropy(logits, y, torch.ones(BATCH))
    grads = torch.autograd.grad(loss, list(params.values()))
    return logits.detach(), dict(zip(params, grads))


def test_stage_windows_follow_the_published_rule():
    model = _model()
    got = [(b.attn.window_size, b.attn.shift_size) for b in _blocks(model)]
    want = []
    for window, half in PUBLISHED:
        want += [(window, (0, 0)), (window, half)]
    assert got == want
    assert [tuple(map(tuple, clip_to_map([12, 12], [s, s]))) for s in MAPS] \
        == PUBLISHED
    assert ref.stage_windows(CFG) == PUBLISHED
    # SwinV2-B @256 w16: maps 64, 32, 16, 8; stage 3 one 16 × 16 window
    # unshifted, stage 4 one unpadded 8 × 8
    b = dict(image_size=256, patch_size=[4, 4], window_size=[16, 16],
             depths=[2, 2, 18, 2])
    assert ref.stage_windows(b) == [((16, 16), (8, 8)), ((16, 16), (8, 8)),
                                    ((16, 16), (0, 0)), ((8, 8), (0, 0))]


def test_clip_needs_the_image_size():
    with pytest.raises(ValueError, match="image_size"):
        SwinTransformerV2(**dict(CFG, image_size=None), device="cpu")


def test_logits_and_gradients_match_the_reference():
    """Training mode, stochastic depth 0.3: the port's logits and every
    leaf's gradient against the reference's (which recomputes each block
    in its backward)."""
    torch.set_num_threads(4)
    x, y = _batch()
    logits, grads = _port_step(_model(), x, y, seed=77)
    want_logits, want_grads = _reference_step(x, y, seed=77)
    scale = float(want_logits.abs().max())
    assert scale > 0.1  # random heads: logits that say something
    assert float((logits - want_logits).abs().max()) <= LOGIT_TOL * scale
    assert set(grads) == set(want_grads)
    median = float(np.median([float(g.norm()) for g in want_grads.values()]))
    for k, g in grads.items():
        w = want_grads[k]
        err = float((g - w).norm())
        assert err <= GRAD_TOL * max(float(w.norm()), median), (k, err)
    # the stochastic-depth masks are the seeds' own: other seeds differ
    other, _ = _reference_step(x, y, seed=78)
    assert float((other - want_logits).abs().max()) > 100 * LOGIT_TOL * scale


def test_unclipped_model_does_not_compute_the_published_one():
    """Without the clip stage 3 attends its 6 × 6 map zero-padded to
    12 × 12 and unmasked: its logits leave the reference's by far more than
    the tolerance."""
    x, _ = _batch()
    with torch.no_grad():
        got = _model(clip_window=False)(x)
        want = ref.forward(_weights(), x, CFG)
    assert float((got - want).abs().max()) > 1e3 * LOGIT_TOL * float(
        want.abs().max())


def test_unclipped_geometry_is_unchanged():
    """Without the argument every stage keeps the full window and the
    alternating half-window shift (the runtime zeroes it where the window
    covers the padded map); the config carries no key; every attention
    call takes the split-head path, stage 3 over a padded map."""
    model = _model(clip_window=False)
    assert all(b.attn.window_size == (12, 12) for b in _blocks(model))
    assert [b.attn.shift_size for b in _blocks(model)] == [(0, 0), (6, 6)] * 3
    assert "clip_window" not in model.config
    tw.ROUTE_LOG = []
    try:
        with torch.no_grad():
            model(_batch()[0])
        assert tw.ROUTE_LOG == ["split"] * 6
    finally:
        tw.ROUTE_LOG = None


def test_routes_and_biased_backward_counters():
    """Stages 1 and 2 (144-token windows) route split, stage 3 (6 × 6)
    batched; the biased backward runs once a split call and counts its
    G·H·N² score elements; on the CPU it is the plain version, so the
    kernel's launch counter stays 0, and so does ``plain_on_card`` (the
    card's calls the kernel does not take). ``reset_launch_counts`` zeroes
    them all."""
    model = _model()
    x, y = _batch()
    tw.ROUTE_LOG = []
    tfa.reset_launch_counts()
    try:
        _port_step(model, x, y, seed=3)
        routes = list(tw.ROUTE_LOG)
    finally:
        tw.ROUTE_LOG = None
    assert routes == ["split"] * 4 + ["batched"] * 2
    # (G = images · windows, H) of the split calls: 2 × 2 windows of 144 at
    # one head, then one window of 144 at two heads
    scores = 2 * (BATCH * 4 * 1 * 144 ** 2) + 2 * (BATCH * 1 * 2 * 144 ** 2)
    assert tfa.BIAS_BWD == {"calls": 4, "score_elements": scores,
                            "plain_on_card": 0}
    assert tfa.LAUNCHES["flash_attention_bias_bwd"] == 0
    tfa.LAUNCHES["flash_attention_bias_bwd"] = 4  # as a card's step counts
    tfa.BIAS_BWD["plain_on_card"] = 1
    tfa.reset_launch_counts()
    assert tfa.BIAS_BWD == {"calls": 0, "score_elements": 0,
                            "plain_on_card": 0}
    assert tfa.LAUNCHES["flash_attention_bias_bwd"] == 0


def _ranges(prof, name):
    zero = prof.profiler.kineto_results.trace_start_ns()
    return [(zero + int(e.time_range.start * 1e3),
             zero + int(e.time_range.end * 1e3))
            for e in prof.events() if e.name == name]


def _inside(prof, op, ranges):
    zero = prof.profiler.kineto_results.trace_start_ns()
    return sum(1 for e in prof.events() if e.name == op and any(
        s <= zero + int(e.time_range.start * 1e3) <= t for s, t in ranges))


def test_spans_wrap_the_split_path_and_the_biased_backward():
    """Under a profiler: one ``vtt.window.split`` a split call, over the
    head split, the attention and the reverse; one ``vtt.attn.bias_bwd``
    a biased backward, over its exponentials and products; both host
    ranges only. Without a profiler neither is kept."""
    model = _model()
    x, y = _batch()
    metrics.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _port_step(model, x, y, seed=3)
    spans, dropped = metrics.take_spans()
    assert dropped == 0
    names = [s.name for s in spans if s.name.startswith(("vtt.window",
                                                         "vtt.attn"))]
    assert names.count("vtt.window.split") == 4
    assert names.count("vtt.attn.bias_bwd") == 4
    split = _ranges(prof, "vtt.window.split")
    bwd = _ranges(prof, "vtt.attn.bias_bwd")
    assert len(split) == len(bwd) == 4
    # the split forward: the contiguous q, k, v copy, the attention's
    # score product, the reverse's reshape; the backward: exp of the
    # scores, the products of dP, dS, dq, dk, dv
    assert _inside(prof, "aten::contiguous", split) >= 4
    assert _inside(prof, "aten::exp", split) >= 4
    assert _inside(prof, "aten::exp", bwd) >= 4
    assert _inside(prof, "aten::matmul", bwd) >= 5 * 4
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events() if e.name.startswith("vtt."))
    _port_step(model, x, y, seed=3)
    assert metrics.take_spans() == ([], 0)


def test_export_and_load_rebuild_the_clipped_model(tmp_path):
    """The manifest keeps ``clip_window``: the loaded classifier has the
    clipped stage windows and predicts as the model does."""
    model = _model()
    model.eval()
    serving.export_classifier(model, (48, 48, 3), str(tmp_path),
                              buckets=(2, 4))
    clf = serving.load_classifier(str(tmp_path), device="cpu")
    assert clf.model.config["clip_window"] is True
    assert [b.attn.window_size for b in _blocks(clf.model)] == \
        [b.attn.window_size for b in _blocks(model)]
    x = np.random.RandomState(9).randn(3, 48, 48, 3).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    got = clf.predict(x)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * math.sqrt(
        float(want.abs().max())))
