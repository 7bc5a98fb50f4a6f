"""The port's DETR stack against the JAX package, on the CPU.

Weights are drawn once from a numpy seed into the JAX params tree (its
shapes from ``jax.eval_shape`` of ``init``, which compiles nothing), run
through the JAX modules, and loaded into the port with
``detr_state_dict_from_jax(...)`` and ``strict=True``. Inputs come from
numpy. Tolerances (fp32): 1e-6 on box ops, 1e-5 on position encodings and
attention-sized maps, 1e-4 on backbone features, transformer outputs,
logits, boxes and losses (the packages sum convolutions and products in
different orders); the numpy-only modules (bucketing, COCO evaluation) and
the scipy matching agree exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.object_detection import backbone as jbb
from vision_transformers_tpu.models.object_detection import criterion as jcrit
from vision_transformers_tpu.models.object_detection import detr as jdetr
from vision_transformers_tpu.models.object_detection import matcher as jmatch
from vision_transformers_tpu.models.object_detection import (
    transformer as jtr,
)
from vision_transformers_tpu.ops import posenc as jposenc
from vision_transformers_tpu.utils.coco import coco_eval as jeval
from vision_transformers_tpu.utils.coco.util import box_ops as jbox
from vision_transformers_tpu.utils.coco.util import misc as jmisc
from vision_transformers_tpu_torch.models.object_detection import (
    backbone as tbb,
)
from vision_transformers_tpu_torch.models.object_detection import (
    criterion as tcrit,
)
from vision_transformers_tpu_torch.models.object_detection import detr as tdetr
from vision_transformers_tpu_torch.models.object_detection import (
    matcher as tmatch,
)
from vision_transformers_tpu_torch.models.object_detection import (
    transformer as ttr,
)
from vision_transformers_tpu_torch.ops import posenc as tposenc
from vision_transformers_tpu_torch.utils.coco import coco_eval as teval
from vision_transformers_tpu_torch.utils.coco.util import box_ops as tbox
from vision_transformers_tpu_torch.utils.coco.util import misc as tmisc
from vision_transformers_tpu_torch.utils.port_jax import (
    detr_state_dict_from_jax,
)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def seeded_params(shapes, seed):
    """A numpy params tree of the given shapes: kernels N(0, 1/fan_in),
    LayerNorm/GroupNorm/FrozenBN scales 1 + N(0, 0.1), FrozenBN variances
    1 + |N(0, 0.1)|, learned embeddings U[0, 1) or N(0, 1), the rest
    N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def value(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = s.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / math.sqrt(
                max(1, int(np.prod(shape[:-1]))))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif name in ("row_embed", "col_embed"):
            a = rng.rand(*shape)
        elif name == "query_embed":
            a = rng.standard_normal(shape)
        else:
            a = 0.02 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(value, shapes)


def jax_params(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kw))
    return seeded_params(shapes["params"], seed)


def load(tmod, params):
    tmod.load_state_dict(detr_state_dict_from_jax(params), strict=True)
    return tmod


# ---------------------------------------------------------------------------
# box ops, bucketing, resize, position encodings


def _boxes(seed, n):
    rng = np.random.RandomState(seed)
    cxcywh = np.concatenate([rng.rand(n, 2) * 0.8 + 0.1,
                             rng.rand(n, 2) * 0.3 + 0.01], axis=1)
    return cxcywh.astype(np.float32)


@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh",
                                "box_area", "box_iou", "generalized_box_iou",
                                "masks_to_boxes"])
def test_box_ops_match_jax(fn):
    a = np.asarray(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(0, 7))))
    b = np.asarray(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(1, 5))))
    if fn in ("box_iou", "generalized_box_iou"):
        args = (a, b)
    elif fn == "masks_to_boxes":
        args = (np.random.RandomState(2).rand(4, 9, 13) > 0.7,)
    else:
        args = (a,)
    want = getattr(jbox, fn)(*(jnp.asarray(x) for x in args))
    got = getattr(tbox, fn)(*(_t(x) for x in args))
    if fn == "box_iou":
        want, got = want[0], got[0]
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    if fn == "generalized_box_iou":
        with pytest.raises(ValueError):
            tbox.generalized_box_iou(_t(a[:, [2, 1, 0, 3]]), _t(b), check=True)


def test_pairwise_box_ops_take_a_batch_dimension():
    a = _t(_boxes(3, 6).reshape(2, 3, 4))
    b = _t(_boxes(4, 8).reshape(2, 4, 4))
    g = tbox.generalized_box_iou(a, b)
    for i in range(2):
        torch.testing.assert_close(g[i], tbox.generalized_box_iou(a[i], b[i]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("sizes", [
    [(60, 90), (100, 70)],
    [(800, 1200), (800, 1333), (666, 1000)],   # COCO scales → 896 × 1344
    [(129, 257)],
])
def test_nested_tensor_bucketing_matches_jax(sizes):
    rng = np.random.RandomState(5)
    images = [rng.rand(h, w, 3).astype(np.float32) for h, w in sizes]
    images[0] = images[0].transpose(2, 0, 1)  # CHW is accepted too
    want = jmisc.nested_tensor_from_tensor_list(images)
    got = tmisc.nested_tensor_from_tensor_list(images)
    np.testing.assert_array_equal(got.tensors, want.tensors)
    np.testing.assert_array_equal(got.mask, want.mask)
    batch = [(im, {"image_id": i}) for i, im in enumerate(images)]
    (nt, targets), (jnt, jtargets) = (tmisc.collate_fn(batch),
                                      jmisc.collate_fn(batch))
    np.testing.assert_array_equal(nt.mask, jnt.mask)
    assert targets == jtargets
    moved = nt.to("cpu")
    assert isinstance(moved.tensors, torch.Tensor) and moved.mask.dtype == \
        torch.bool
    assert tuple(moved.shape) == got.tensors.shape


def test_coco_size_bucket():
    assert tmisc.bucket_size(800) == 896 and tmisc.bucket_size(1333) == 1344
    assert tmisc.bucket_size(2000) == 1344
    nt = tmisc.nested_tensor_from_tensor_list(
        [np.zeros((800, 1333, 3), np.float32)])
    assert nt.tensors.shape == (1, 896, 1344, 3)
    assert (896 // 16) * (1344 // 16) == 4704  # C5 tokens of DETR-R50 DC5


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_interpolate_matches_jax(mode, layout):
    x = np.random.RandomState(6).rand(2, 3, 17, 23).astype(np.float32)
    if layout == "nhwc":
        x = x.transpose(0, 2, 3, 1).copy()
    for size in ((9, 11), (34, 40)):
        want = jmisc.interpolate(jnp.asarray(x), size=size, mode=mode)
        got = tmisc.interpolate(_t(x), size=size, mode=mode)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,w,out", [(40, 40, (5, 5)), (37, 51, (6, 7)),
                                     (56, 84, (7, 11))])
def test_mask_resize_is_jax_nearest(h, w, out):
    """Joiner's mask resize: jax.image.resize 'nearest' is nearest-exact."""
    mask = np.zeros((2, h, w), bool)
    mask[0, :, 27 * w // 40:] = True
    mask[1, 3 * h // 5:, :] = True
    want = np.asarray(jax.image.resize(jnp.asarray(mask, jnp.float32),
                                       (2, *out), "nearest")).astype(bool)
    got = torch.nn.functional.interpolate(
        _t(mask)[:, None].float(), size=out, mode="nearest-exact")[:, 0]
    np.testing.assert_array_equal(got.bool().numpy(), want)
    if (h, w, out) == (40, 40, (5, 5)):  # the trap: torch's "nearest" differs
        plain = torch.nn.functional.interpolate(
            _t(mask)[:, None].float(), size=out, mode="nearest")[:, 0]
        assert list(want[0, 0]) == [False] * 3 + [True] * 2
        assert not np.array_equal(plain.bool().numpy(), want)


def _pad_mask(b, h, w):
    mask = np.zeros((b, h, w), bool)
    mask[0, :, w - 2:] = True
    if b > 1:
        mask[1, h - 3:, :] = True
    return mask


def test_sine_position_encoding_matches_jax():
    x = np.zeros((2, 6, 9, 4), np.float32)
    mask = _pad_mask(2, 6, 9)
    jmod = jdetr.SinePositionalEncoding(num_pos_feats=16)
    for m in (mask, None):
        want = jmod.apply({}, jnp.asarray(x),
                          None if m is None else jnp.asarray(m))
        got = tdetr.SinePositionalEncoding(16)(
            _t(x), None if m is None else _t(m))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_learned_position_encoding_matches_jax():
    x = np.zeros((2, 5, 7, 8), np.float32)
    jmod = jdetr.AbsolutePositionalEncoding(positional_features=16)
    params = jax_params(jmod, jnp.asarray(x), seed=8)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = load(tdetr.AbsolutePositionalEncoding(16), params)(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=0, rtol=0)


@pytest.mark.parametrize("with_cls", [True, False])
def test_conditional_position_encoding_matches_jax(with_cls):
    b, d, grid = 2, 8, (4, 5)
    n = grid[0] * grid[1] + (1 if with_cls else 0)
    x = np.random.RandomState(9).randn(b, n, d).astype(np.float32)
    jmod = jposenc.ConditionalPositionalEncoding(with_cls=with_cls)
    params = jax_params(jmod, jnp.asarray(x), grid, seed=10)
    want = jmod.apply({"params": params}, jnp.asarray(x), grid)
    tmod = load(tposenc.ConditionalPositionalEncoding(d, with_cls=with_cls),
                params)
    np.testing.assert_allclose(_np(tmod(_t(x), grid)), _np(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(tposenc.sincos_pos_embed_2d(16, 3, 5),
                                  jposenc.sincos_pos_embed_2d(16, 3, 5))


# ---------------------------------------------------------------------------
# backbone, transformer, DETR


@pytest.mark.parametrize("norm", ["frozen_bn", "group"])
def test_small_resnet_matches_jax(norm):
    """``ResNet(stage_sizes=(1, 1, 1, 1))`` with the dilated C5: every level."""
    x = np.random.RandomState(11).rand(2, 64, 96, 3).astype(np.float32)
    jmod = jbb.ResNet(stage_sizes=(1, 1, 1, 1), norm=norm)
    params = jax_params(jmod, jnp.asarray(x), seed=12)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = load(tbb.ResNet(stage_sizes=(1, 1, 1, 1), norm=norm), params)
    got = tmod(_t(x))
    assert sorted(got) == sorted(want) == ["0", "1", "2", "3"]
    assert got["3"].shape == (2, 4, 6, 2048)  # stride 16: C5 dilated
    for key in want:
        scale = max(1.0, float(np.abs(_np(want[key])).max()))
        np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                   atol=1e-4 * scale, rtol=0)


def test_frozen_bn_takes_no_gradient():
    bn = tbb.FrozenBatchNorm(4)
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    bn(x).sum().backward()
    assert x.grad is not None
    assert all(p.grad is None and p.requires_grad for p in bn.parameters())


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before):
    d, heads, q = 32, 4, 10
    rng = np.random.RandomState(13)
    src = rng.randn(2, 4, 6, d).astype(np.float32)
    pos = rng.randn(2, 4, 6, d).astype(np.float32)
    query = rng.randn(q, d).astype(np.float32)
    mask = _pad_mask(2, 4, 6)
    kw = dict(d_model=d, nhead=heads, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64,
              normalize_before=normalize_before, return_intermediate_dec=True)
    jmod = jtr.Transformer(**kw)
    args = (jnp.asarray(src), jnp.asarray(mask), jnp.asarray(query),
            jnp.asarray(pos))
    params = jax_params(jmod, *args, seed=14)
    want_hs, want_mem = jmod.apply({"params": params}, *args)
    tmod = load(ttr.Transformer(**kw), params).eval()
    hs, mem = tmod(_t(src), _t(mask), _t(query), _t(pos))
    assert hs.shape == (2, 2, q, d)
    np.testing.assert_allclose(_np(hs), _np(want_hs), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(mem), _np(want_mem), atol=1e-4, rtol=0)
    # padded keys do not reach the decoder
    src2 = src.copy()
    src2[:, :, 4:] = 123.0
    hs2, _ = tmod(_t(src2), _t(mask), _t(query), _t(pos))
    np.testing.assert_allclose(_np(hs2[:, 0]), _np(hs[:, 0]), atol=1e-4,
                               rtol=0)


def test_vit_backbone_matches_jax():
    kw = dict(hidden_dim=32, patch_size=8, num_layers=2, num_heads=2,
              mlp_dim=64)
    x = np.random.RandomState(15).rand(2, 36, 44, 3).astype(np.float32)
    jmod = jbb.ViTBackbone(**kw)
    params = jax_params(jmod, jnp.asarray(x), seed=16)
    want = jmod.apply({"params": params}, jnp.asarray(x))["0"]
    got = load(tbb.ViTBackbone(**kw), params).eval()(_t(x))["0"]
    assert got.shape == (2, 5, 6, 32)  # padded to 40 × 48
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


TINY = dict(num_classes=5, num_queries=8, hidden_dim=32, nheads=4,
            num_encoder_layers=1, num_decoder_layers=2, dim_feedforward=64,
            dropout=0.0, aux_loss=True)


@pytest.fixture(scope="module")
def tiny_detr():
    """The tiny DETR of tests/test_detr.py, full ResNet-50 backbone, one
    draw of weights shared by both packages."""
    x = np.random.RandomState(17).rand(2, 64, 96, 3).astype(np.float32)
    mask = _pad_mask(2, 64, 96) | False
    mask[0, :, 70:] = True
    jmod = jdetr.Detr(**TINY)
    params = jax_params(jmod, jnp.asarray(x), jnp.asarray(mask), seed=18)
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tmod = load(tdetr.Detr(**TINY, device="cpu"), params)
    return params, x, mask, want, tmod


def test_detr_forward_matches_jax(tiny_detr):
    _, x, mask, want, tmod = tiny_detr
    with torch.no_grad():
        got = tmod(_t(x), _t(mask))
    assert got["pred_logits"].shape == (2, 8, 6)
    assert got["pred_boxes"].shape == (2, 8, 4)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 1
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(_np(got["aux_outputs"][0][key]),
                                   _np(want["aux_outputs"][0][key]),
                                   atol=1e-4, rtol=0)


def test_detr_state_dict_covers_every_parameter(tiny_detr):
    params, _, _, _, tmod = tiny_detr
    sd = detr_state_dict_from_jax(params)
    assert set(sd) == set(tmod.state_dict())
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in tmod.parameters())
    conv = sd["joiner.backbone.layer1_block0.conv2.weight"]
    assert conv.shape == (64, 64, 3, 3)
    assert sd["input_proj.weight"].shape == (32, 2048, 1, 1)
    assert sd["joiner.backbone.bn1.var"].shape == (64,)
    bad = dict(sd)
    bad.pop("query_embed")
    with pytest.raises(RuntimeError, match="query_embed"):
        tmod.load_state_dict(bad, strict=True)


def test_post_process_matches_jax(tiny_detr):
    _, x, mask, want, tmod = tiny_detr
    sizes = np.asarray([[60, 90], [64, 70]], np.float32)
    want_r = jdetr.PostProcess()(want, jnp.asarray(sizes))
    with torch.no_grad():
        got_r = tdetr.PostProcess()(tmod(_t(x), _t(mask)), _t(sizes))
    for g, w in zip(got_r, want_r):
        np.testing.assert_array_equal(g["labels"].numpy(),
                                      np.asarray(w["labels"]))
        np.testing.assert_allclose(_np(g["scores"]), _np(w["scores"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(g["boxes"]), _np(w["boxes"]),
                                   atol=1e-2, rtol=0)  # pixels: ~1e-4 · 90


def test_detr_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdetr.Detr(**TINY)
    with pytest.raises(ValueError, match="arch"):
        tbb.build_backbone(arch="resnet18")


# ---------------------------------------------------------------------------
# matcher, criterion, COCO evaluation


def _outputs(seed, b=2, q=10, c=5):
    rng = np.random.RandomState(seed)
    return {"pred_logits": rng.randn(b, q, c + 1).astype(np.float32),
            "pred_boxes": _boxes(seed + 1, b * q).reshape(b, q, 4)}


TARGETS = [
    {"labels": np.array([1, 3]), "boxes": _boxes(40, 2)},
    {"labels": np.array([0, 2, 4]), "boxes": _boxes(41, 3)},
]


def test_prepare_targets_matches_jax():
    want = jmatch.prepare_targets(TARGETS, 4, 5)
    got = tmatch.prepare_targets(TARGETS, 4, 5, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scipy_matcher_matches_jax_scipy(seed):
    out = _outputs(seed)
    labels, boxes, valid = jmatch.prepare_targets(TARGETS, 4, 5)
    want = jmatch.HungarianMatcher(method="scipy")(
        {k: jnp.asarray(v) for k, v in out.items()}, labels, boxes, valid)
    got = tmatch.HungarianMatcher(method="scipy")(
        {k: _t(v) for k, v in out.items()},
        *tmatch.prepare_targets(TARGETS, 4, 5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # "auto" on the CPU is scipy, as in the JAX package off the TPU
    auto = tmatch.HungarianMatcher()({k: _t(v) for k, v in out.items()},
                                     *tmatch.prepare_targets(TARGETS, 4, 5))
    np.testing.assert_array_equal(auto.numpy(), got.numpy())


@pytest.mark.parametrize("q,t,n_valid", [(10, 4, 4), (20, 8, 5), (100, 12, 9)])
def test_auction_matches_scipy_and_jax(q, t, n_valid):
    rng = np.random.RandomState(q + t)
    cost = rng.rand(3, q, t).astype(np.float32)
    valid = np.zeros((3, t), bool)
    valid[:, :n_valid] = True
    valid[2, 1:] = False  # one image with a single target
    got = tmatch.auction_assign(_t(cost), _t(valid))
    want = tmatch._host_assign(cost, valid)
    for i in range(3):
        n = int(valid[i].sum())
        assert sorted(got[i, :n].tolist()) == sorted(set(got[i, :n].tolist()))
        assert (got[i, n:] == -1).all()
        opt = cost[i, want[i, :n], np.arange(n)].sum()
        mine = cost[i, got[i, :n].numpy(), np.arange(n)].sum()
        assert mine <= opt + 1e-4  # optimal on well-separated random costs
    jgot = np.stack([np.asarray(jmatch.auction_assign(jnp.asarray(c),
                                                      jnp.asarray(v)))
                     for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_auction_greedy_completion_matches_jax():
    """Cut the auction short: the greedy completion fills the stragglers as
    the JAX function's does."""
    cost = np.random.RandomState(50).rand(2, 12, 6).astype(np.float32)
    valid = np.ones((2, 6), bool)
    got = tmatch.auction_assign(_t(cost), _t(valid), max_rounds=1)
    jgot = np.stack([np.asarray(jmatch.auction_assign(
        jnp.asarray(c), jnp.asarray(v), max_rounds=1))
        for c, v in zip(cost, valid)])
    np.testing.assert_array_equal(got.numpy(), jgot)
    assert all(len(set(r)) == 6 for r in got.tolist())


def test_set_criterion_matches_jax():
    out = _outputs(60)
    aux = _outputs(61)
    labels, boxes, valid = jmatch.prepare_targets(TARGETS, 4, 5)
    jout = {k: jnp.asarray(v) for k, v in out.items()}
    jout["aux_outputs"] = [{k: jnp.asarray(v) for k, v in aux.items()}]
    tout = {k: _t(v) for k, v in out.items()}
    tout["aux_outputs"] = [{k: _t(v) for k, v in aux.items()}]
    jc = jcrit.SetCriterion(num_classes=5)
    tc = tcrit.SetCriterion(num_classes=5)
    targets = tmatch.prepare_targets(TARGETS, 4, 5)
    for num_boxes in (None, 7.0):
        want = jc(jout, labels, boxes, valid, num_boxes=num_boxes)
        got = tc(tout, *targets, num_boxes=None if num_boxes is None
                 else torch.tensor(num_boxes))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=1e-5,
                                       rtol=0, err_msg=k)
        np.testing.assert_allclose(_np(tc.total_loss(got)),
                                   _np(jc.total_loss(want)), atol=1e-4,
                                   rtol=0)


def test_evaluate_detections_matches_jax():
    rng = np.random.RandomState(70)
    gts, preds = {}, {}
    for img in range(6):
        n, m = rng.randint(1, 6), rng.randint(0, 12)
        xy = rng.rand(n, 2) * 200
        gts[img] = {"boxes": np.concatenate([xy, xy + rng.rand(n, 2) * 120 + 4],
                                            axis=1),
                    "labels": rng.randint(0, 3, n)}
        if img == 2:
            gts[img]["iscrowd"] = np.arange(n) == 0
        pxy = rng.rand(m, 2) * 200
        preds[img] = {"boxes": np.concatenate(
            [pxy, pxy + rng.rand(m, 2) * 120 + 4], axis=1),
            "labels": rng.randint(0, 3, m), "scores": rng.rand(m)}
    preds[3] = {k: np.copy(v) for k, v in gts[3].items()}
    preds[3]["scores"] = np.ones(len(gts[3]["labels"]))
    want = jeval.evaluate_detections(gts, preds)
    got = teval.evaluate_detections(gts, preds)
    assert got == want and 0.0 < got["mAP"] < 1.0
