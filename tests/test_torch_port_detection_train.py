"""DETR training in the port against the JAX package, on the CPU.

- A 3-step ``fit_detection`` trajectory at dropout 0 (the tiny DETR of
  tests/test_detr.py with its full ResNet-50, one draw of weights loaded
  into both packages, the same loader): the epoch's mean loss, the final
  parameters and the batch's loss after the steps, fp32, 1e-4. Matching is
  scipy's on both sides ("auto" on the CPU). ``k_proj.bias`` is left out
  of the parameter comparison: its true gradient is 0 (softmax ignores a
  shift of every key's score), so each package's Adam turns its own
  rounding noise into steps of size lr.
- The same trajectory data parallel, ``fit_detection(mesh=...)`` in a gloo
  group of 2 processes, against the same JAX run.
- The per-label AdamW with per-group clipping and ``lr_drop`` against
  ``optax.multi_transform`` of two chains, 1e-6; FrozenBatchNorm leaves
  take no gradient and are decayed.
- ``DetectionLoader`` batches, ``evaluate_model`` metrics and the metric
  loggers against the JAX package's.
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_detr import TINY, jax_params
from vision_transformers_tpu.models.object_detection import Detr as JDetr
from vision_transformers_tpu.models.object_detection import SetCriterion as JC
from vision_transformers_tpu.models.object_detection import (
    prepare_targets as jprep,
)
from vision_transformers_tpu.training import detection as jdet
from vision_transformers_tpu.utils import metrics as jmetrics
from vision_transformers_tpu_torch.models.object_detection import (
    Detr,
    SetCriterion,
    prepare_targets,
)
from vision_transformers_tpu_torch.models.object_detection.backbone import (
    FrozenBatchNorm,
)
from vision_transformers_tpu_torch.training import detection as tdet
from vision_transformers_tpu_torch.utils import metrics as tmetrics
from vision_transformers_tpu_torch.utils.coco.util.misc import reduce_dict
from vision_transformers_tpu_torch.utils.port_jax import (
    detr_state_dict_from_jax,
)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


class SyntheticDetection:
    """Map-style dataset of (HWC float image, target) with unequal sizes,
    so every batch has real padding masks; boxes rel-cxcywh."""

    def __init__(self, n=6, seed=0):
        rng = np.random.RandomState(seed)
        self.items = []
        for i in range(n):
            h, w = 50 + 7 * i, 90 - 5 * i
            k = 1 + i % 3
            boxes = np.concatenate([rng.rand(k, 2) * 0.6 + 0.2,
                                    rng.rand(k, 2) * 0.3 + 0.05], axis=1)
            self.items.append((
                rng.rand(h, w, 3).astype(np.float32),
                {"labels": rng.randint(0, 5, k),
                 "boxes": boxes.astype(np.float32),
                 "image_id": np.asarray([i]),
                 "orig_size": np.asarray([h, w])}))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def trajectory():
    """Both packages' fit_detection, 1 epoch of 3 batches of 2, from one
    draw of weights."""
    ds = SyntheticDetection()
    first = jdet.DetectionLoader(ds, 2)
    nt, _ = next(iter(first))
    jmod = JDetr(**TINY)
    params = jax_params(jmod, jnp.asarray(nt.tensors[:1]),
                        jnp.asarray(nt.mask[:1]), seed=30)
    kw = dict(num_classes=5, max_targets=4, verbose=False, lr_drop=1)
    jhist = jdet.fit_detection(jmod, jdet.DetectionLoader(ds, 2), 1,
                               init_params=params, **kw)
    tmod = Detr(**TINY, device="cpu")
    thist = tdet.fit_detection(tmod, tdet.DetectionLoader(ds, 2), 1,
                               init_params=detr_state_dict_from_jax(params),
                               **kw)
    return ds, jmod, jhist, tmod, thist, params


def test_fit_detection_trajectory_matches_jax(trajectory):
    ds, jmod, jhist, tmod, thist, _ = trajectory
    assert thist["final_state"].step == 3
    np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=1e-4,
                               rtol=0)
    want = detr_state_dict_from_jax(
        jax.device_get(jhist["final_state"].params))
    got = tmod.state_dict()
    _assert_params_match(got, want)


def _assert_params_match(got, want):
    moved = 0
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            continue
        np.testing.assert_allclose(_np(got[name]), _np(w), atol=1e-4, rtol=0,
                                   err_msg=name)
        moved += 1
    assert moved > 300


def test_fit_detection_data_parallel_matches_jax(trajectory, tmp_path):
    """``fit_detection(mesh=...)`` in a gloo group of 2 processes (the
    workers of ``tests/test_torch_port_multiprocess.py``), each rank one
    image of each batch of 2, from the trajectory's weights: the same
    losses and final parameters as JAX's run, 1e-4."""
    from tests.test_torch_port_multiprocess import spawn

    ds, jmod, jhist, tmod, thist, params = trajectory
    np.savez(tmp_path / "detr_refs.npz", **{
        k: v.numpy() for k, v in detr_state_dict_from_jax(params).items()})
    spawn(2, tmp_path, mode="detr")
    got = dict(np.load(tmp_path / "detr_out.npz"))
    np.testing.assert_allclose(got.pop("loss"), jhist["loss"], atol=1e-4,
                               rtol=0)
    _assert_params_match(got, detr_state_dict_from_jax(
        jax.device_get(jhist["final_state"].params)))


def test_trained_batch_loss_matches_jax(trajectory):
    """The loss of the first batch under the trained weights, eval mode."""
    ds, jmod, jhist, tmod, thist, _ = trajectory
    nt, targets = next(iter(tdet.DetectionLoader(ds, 2)))
    jout = jax.jit(jmod.apply)({"params": jhist["final_state"].params},
                               jnp.asarray(nt.tensors), jnp.asarray(nt.mask))
    jc = JC(num_classes=5)
    want = jc.total_loss(jc(jout, *jprep(targets, 4, 5)))
    with torch.no_grad():
        tmod.eval()
        tout = tmod(torch.from_numpy(nt.tensors), torch.from_numpy(nt.mask))
    tc = SetCriterion(num_classes=5)
    got = tc.total_loss(tc(tout, *prepare_targets(targets, 4, 5)))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    assert np.isfinite(float(got))


def test_frozen_batch_norm_leaves_are_decayed_not_trained(trajectory):
    """They take no gradient, but AdamW decays them (lr_backbone 1e-5,
    weight decay 1e-4: a leaf v moves to v·(1 − 1e-9) per step), as
    ``optax.adamw`` decays every leaf of the JAX tree."""
    _, _, jhist, tmod, _, _ = trajectory
    jparams = jax.device_get(jhist["final_state"].params)
    var_j = np.asarray(jparams["joiner"]["backbone"]["bn1"]["var"])
    var_t = _np(tmod.joiner.backbone.bn1.var)
    np.testing.assert_allclose(var_t, var_j, atol=1e-7, rtol=0)
    assert all(p.grad is None for m in tmod.modules()
               if isinstance(m, FrozenBatchNorm) for p in m.parameters())


class _Toy(torch.nn.Module):
    """Parameters named like DETR's: two under ``joiner.backbone``, two in
    the head, one frozen leaf under the backbone."""

    def __init__(self):
        super().__init__()
        self.joiner = torch.nn.Module()
        self.joiner.backbone = torch.nn.Module()
        self.joiner.backbone.w = torch.nn.Parameter(torch.zeros(3, 4))
        self.joiner.backbone.var = torch.nn.Parameter(torch.zeros(4))
        self.head = torch.nn.Module()
        self.head.w = torch.nn.Parameter(torch.zeros(4, 2))
        self.head.b = torch.nn.Parameter(torch.zeros(2))


@pytest.mark.parametrize("lr_backbone", [1e-2, None])
def test_detection_optimizer_matches_optax(lr_backbone):
    rng = np.random.RandomState(40)
    init = {"joiner": {"backbone": {"w": rng.randn(3, 4), "var": 1 + rng.rand(4)}},
            "head": {"w": rng.randn(4, 2), "b": rng.randn(2)}}
    init = jax.tree_util.tree_map(lambda a: a.astype(np.float32), init)
    model = _Toy()
    with torch.no_grad():
        for name, p in model.named_parameters():
            node = init
            for part in name.split("."):
                node = node[part]
            p.copy_(torch.from_numpy(node))
    lr, wd, clip, drop_at = 1e-1, 1e-2, 0.5, 3
    tx = tdet.make_detection_optimizer(
        model, lr=lr, lr_backbone=lr_backbone, weight_decay=wd,
        grad_clip=clip, lr_drop_step=drop_at)

    def chain(base):
        return optax.chain(optax.clip_by_global_norm(clip), optax.adamw(
            optax.piecewise_constant_schedule(base, {drop_at: 0.1}),
            weight_decay=wd))

    if lr_backbone is None:
        jtx = chain(lr)
    else:
        labels = {"joiner": {"backbone": {"w": "backbone", "var": "backbone"}},
                  "head": {"w": "main", "b": "main"}}
        jtx = optax.multi_transform(
            {"main": chain(lr), "backbone": chain(lr_backbone)}, labels)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    state = jtx.init(jp)
    for step in range(5):
        grads = {"joiner": {"backbone": {"w": rng.randn(3, 4) * (step + 1),
                                         "var": np.zeros(4)}},
                 "head": {"w": rng.randn(4, 2), "b": rng.randn(2) * 3}}
        grads = jax.tree_util.tree_map(lambda a: a.astype(np.float32), grads)
        tx.zero_grad()
        for name, p in model.named_parameters():
            if name != "joiner.backbone.var":  # takes no gradient
                node = grads
                for part in name.split("."):
                    node = node[part]
                p.grad = torch.from_numpy(node.copy())
        tx.step()
        updates, state = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, p in model.named_parameters():
            node = jp
            for part in name.split("."):
                node = node[part]
            np.testing.assert_allclose(_np(p), _np(node), atol=1e-6, rtol=0,
                                       err_msg=f"{name} step {step}")
    assert set(tx.groups) == ({"main"} if lr_backbone is None
                              else {"main", "backbone"})


def test_lr_drop_schedule_reads_like_optax():
    """optax's piecewise_constant_schedule(1, {3: 0.1}) reads 1, 1, 1, 0.1,
    0.1 at counts 0-4: the drop applies from count 3 on."""
    tx = tdet.make_detection_optimizer(
        _Toy(), lr=1.0, lr_backbone=None, weight_decay=0.0, grad_clip=1.0,
        lr_drop_step=3)
    sched = optax.piecewise_constant_schedule(1.0, {3: 0.1})
    got = [tx.groups["main"].lr_at(c) for c in range(5)]
    assert got == pytest.approx([float(sched(c)) for c in range(5)],
                                abs=1e-7)
    assert got == pytest.approx([1.0, 1.0, 1.0, 0.1, 0.1], abs=1e-7)


@pytest.mark.parametrize("shuffle", [False, True])
def test_detection_loader_matches_jax(shuffle):
    ds = SyntheticDetection(n=5, seed=3)
    jl = jdet.DetectionLoader(ds, 2, shuffle=shuffle, seed=7)
    tl = tdet.DetectionLoader(ds, 2, shuffle=shuffle, seed=7)
    assert len(tl) == len(jl) == 3
    for _ in range(2):  # two epochs: the shuffle is seeded per epoch
        for (nt, t), (jnt, jt) in zip(tl, jl, strict=True):
            np.testing.assert_array_equal(nt.tensors, jnt.tensors)
            np.testing.assert_array_equal(nt.mask, jnt.mask)
            assert [int(x["image_id"][0]) for x in t] == \
                [int(x["image_id"][0]) for x in jt]
    assert len(tdet.DetectionLoader(ds, 2, drop_last=True)) == 2
    # the port's loader pads to its size_bucket (the JAX one stores it and
    # pads to 128 whatever it is)
    nt, _ = next(iter(tdet.DetectionLoader(ds, 2, size_bucket=32)))
    assert nt.tensors.shape[1:3] == (64, 96)


def test_evaluate_model_matches_jax():
    ds = SyntheticDetection(n=4, seed=5)
    rng = np.random.RandomState(6)
    fixed = [{"pred_logits": rng.randn(2, 8, 6).astype(np.float32),
              "pred_boxes": rng.rand(2, 8, 4).astype(np.float32) * 0.5 + 0.2}
             for _ in range(2)]
    calls = iter(fixed + fixed)
    # the first batch's ground truth, predicted well: the mAP is not 0
    fixed[0]["pred_boxes"][:, :3] = np.stack(
        [np.pad(ds[i][1]["boxes"], ((0, 3 - len(ds[i][1]["boxes"])), (0, 0)),
                constant_values=0.5) for i in range(2)])

    def jpredict(images, mask):
        return {k: jnp.asarray(v) for k, v in next(calls).items()}

    def tpredict(images, mask):
        assert images.device.type == "cpu" and mask.dtype == torch.bool
        return {k: torch.from_numpy(v) for k, v in next(calls).items()}

    want = jdet.evaluate_model(jpredict, jdet.DetectionLoader(ds, 2))
    got = tdet.evaluate_model(tpredict, tdet.DetectionLoader(ds, 2),
                              device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_fit_detection_evaluates_and_reproduces_dropout():
    """With dropout 0.1 the masks come from the model's generator, seeded by
    ``seed``: two runs from the same weights give the same losses; the
    validation metrics come back per epoch."""
    ds = SyntheticDetection(n=4, seed=8)
    kw = dict(num_queries=4, hidden_dim=32, nheads=4, num_encoder_layers=1,
              num_decoder_layers=1, dim_feedforward=32, dropout=0.1,
              backbone_norm="group", device="cpu")
    losses = []
    for _ in range(2):
        model = Detr(num_classes=5, seed=1, **kw)
        hist = tdet.fit_detection(model, tdet.DetectionLoader(ds, 2), 1,
                                  val_loader=tdet.DetectionLoader(ds, 2),
                                  num_classes=5, max_targets=4, seed=3,
                                  verbose=False)
        losses.append(hist["loss"])
        assert "mAP" in hist["metrics"][0] and np.isfinite(hist["loss"][0])
    assert losses[0] == losses[1]
    # a mesh that is not parallel.make_mesh's (a JAX mesh, say) is refused
    with pytest.raises(TypeError, match="make_mesh's Mesh"):
        tdet.fit_detection(model, tdet.DetectionLoader(ds, 2), 1,
                           num_classes=5, mesh=object())


def test_metric_logger_matches_jax():
    tv, jv = tmetrics.SmoothedValue(window_size=3), jmetrics.SmoothedValue(
        window_size=3)
    for x in (1.0, 4.0, 2.0, 8.0):
        tv.update(x)
        jv.update(x)
    assert str(tv) == str(jv)
    assert (tv.median, tv.avg, tv.global_avg, tv.max, tv.value) == \
        (jv.median, jv.avg, jv.global_avg, jv.max, jv.value)
    outs = []
    for mod in (tmetrics, jmetrics):
        logger = mod.MetricLogger()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for i in logger.log_every(range(3), 2, header="h"):
                logger.update(loss=float(i))
        outs.append((str(logger), buf.getvalue().count("\n")))
    assert outs[0] == outs[1]
    logits = np.random.RandomState(9).randn(6, 5).astype(np.float32)
    labels = np.asarray([0, 1, 2, 3, 4, 0])
    assert tmetrics.accuracy_topk(torch.from_numpy(logits),
                                  torch.from_numpy(labels), (1, 3)) == \
        pytest.approx(jmetrics.accuracy_topk(logits, labels, (1, 3)))
    assert reduce_dict({"a": 1.0}) == {"a": 1.0}


def test_step_timer_and_profile_trace(tmp_path):
    with tmetrics.step_timer("cpu") as t:
        torch.ones(8).sum()
    assert t["seconds"] >= 0.0
    with tmetrics.profile_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").exists()
