"""The port's PVT and Twins-SVT against the JAX package, CIFAR size.

Same weights in both packages (JAX params, perturbed from a numpy seed so
that no bias or LayerNorm parameter stays at its initial 0 or 1, converted
by ``pvt_state_dict_from_jax`` / ``twins_state_dict_from_jax`` and loaded
with ``strict=True``), same numpy inputs, fp32 on the CPU, where the port's
attention wrappers take their plain versions. JAX runs under the highest
matmul precision. Tolerance: 1e-4 on logits and gradients of O(1) after a
whole model. The modules under the models are in
``tests/test_torch_port_pvt_twins.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_pvt_twins import _apply, _close, _load, _perturbed_params, _randn
from vision_transformers_tpu.models.image_classification import pvt as jpvt
from vision_transformers_tpu.models.image_classification import (
    twins_svt as jtwins,
)
from vision_transformers_tpu.training import trainer as jtrainer
from vision_transformers_tpu.utils.args import get_args as jget_args
from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import PVT, TwinSVT
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import windows as TW
from vision_transformers_tpu_torch.training import trainer as ttrainer
from vision_transformers_tpu_torch.utils.args import get_args
from vision_transformers_tpu_torch.utils.port_jax import (
    pvt_state_dict_from_jax,
    twins_state_dict_from_jax,
)

TOL = 1e-4

PVT_CFG = dict(image_size=32, patch_size=4, embed_dims=[16, 32, 32, 64],
               num_heads=[1, 2, 2, 4], mlp_ratios=[4, 4, 2, 2],
               depths=[1, 1, 1, 1], sr_ratios=[4, 2, 2, 1], qkv_bias=True,
               num_classes=10)
TWINS_CFG = dict(img_size=32, patch_size=4, embed_dims=[16, 32, 64],
                 num_heads=[1, 2, 4], mlp_ratios=[4, 4, 2], depths=[2, 2, 2],
                 sr_ratios=[4, 2, 1], wss=[7, 7, 7], qkv_bias=True,
                 num_classes=10)
MODELS = {
    "pvt": (jpvt.PVT, PVT, PVT_CFG, pvt_state_dict_from_jax),
    "twins": (jtwins.TwinSVT, TwinSVT, TWINS_CFG, twins_state_dict_from_jax),
}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    jcls, tcls, cfg, convert = MODELS[request.param]
    jmodel = jcls(**cfg)
    params = _perturbed_params(jmodel, 0, jnp.zeros((1, 32, 32, 3)))
    tmodel = _load(tcls(**cfg, device="cpu"), params, convert)
    return request.param, jmodel, params, tmodel


def test_logits_match_jax(pair):
    _, jmodel, params, tmodel = pair
    x = _randn(1, 3, 32, 32, 3)
    want = np.asarray(_apply(jmodel, params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.shape == (3, 10) and np.abs(want).max() > 0.1
    _close(got, want, TOL)


def test_parameter_gradients_match_jax(pair):
    """Loss gradients for every parameter in training mode (all dropout and
    drop-path rates 0, so both packages are deterministic)."""
    name, jmodel, params, tmodel = pair
    convert = MODELS[name][3]
    x, y = _randn(2, 4, 32, 32, 3), np.array([1, 7, 3, 0], np.int32)
    w = np.ones(4, np.float32)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              deterministic=False)
        return jtrainer.cross_entropy_with_weights(
            logits, jnp.asarray(y), jnp.asarray(w))

    with jax.default_matmul_precision("highest"):
        want_loss, want = jax.value_and_grad(loss)(params)
    want = convert(jax.device_get(want))
    tmodel.train()
    tmodel.zero_grad()
    got_loss = ttrainer.cross_entropy_with_weights(
        tmodel(torch.from_numpy(x)), torch.from_numpy(y).long(),
        torch.from_numpy(w))
    got_loss.backward()
    tmodel.eval()
    assert abs(got_loss.item() - float(want_loss)) <= TOL
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want)
    for key, p in named.items():
        _close(p.grad, want[key], TOL)
    tmodel.zero_grad()


def test_state_dict_names_mirror_the_jax_tree(pair):
    name, _, params, tmodel = pair
    sd = MODELS[name][3](params)
    assert set(sd) == set(tmodel.state_dict())
    if name == "pvt":
        assert sd["cls_token"].shape == (1, 1, 64)
        assert sd["position_embedding1"].shape == (1, 64, 16)
        assert sd["position_embedding4"].shape == (1, 1 + 1, 64)
        assert sd["patch_embedding2.proj.weight"].shape == (32, 2 * 2 * 16)
        assert sd["block1_0.attn.sr.weight"].shape == (16, 4 * 4 * 16)
        assert "block4_0.attn.sr.weight" not in sd      # sr_ratio 1
    else:
        assert sd["pos_block1.proj.weight"].shape == (32, 1, 3, 3)
        assert sd["block0_0.attn.qkv_kernel"].shape == (16, 48)   # LSA, raw
        assert sd["block0_1.attn.kv.weight"].shape == (32, 16)    # GSA
        assert sd["block2_1.attn.q.bias"].shape == (64,)


@pytest.mark.parametrize("canon,size", [(32, 64), (64, 32)])
def test_pvt_resizes_its_position_embedding_as_jax(canon, size):
    """An image size other than the configured one: every stage's position
    embedding goes through the bilinear resize, enlarging (half-pixel
    centres) and shrinking (antialiased)."""
    cfg = dict(PVT_CFG, image_size=canon)
    jmodel = jpvt.PVT(**cfg)
    params = _perturbed_params(jmodel, 3, jnp.zeros((1, canon, canon, 3)))
    tmodel = _load(PVT(**cfg, device="cpu"), params, pvt_state_dict_from_jax)
    x = _randn(4, 2, size, size, 3)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    _close(got, _apply(jmodel, params, jnp.asarray(x)), TOL)


def test_headless_models_return_features():
    x = torch.from_numpy(_randn(5, 2, 32, 32, 3))
    pvt = PVT(**dict(PVT_CFG, num_classes=0), device="cpu")
    twins = TwinSVT(**dict(TWINS_CFG, num_classes=0), device="cpu")
    with torch.no_grad():
        assert pvt(x).shape == (2, 64) and twins(x).shape == (2, 64)
    assert pvt.head is None and "head.weight" not in twins.state_dict()


def test_twins_routes_on_the_cifar_grids():
    """ws 7 on 8×8, 4×4 and 2×2 grids: stage 1 pads to 14×14 and masks (a
    per-window bias over four windows: fused flat); stages 2 and 3 are one
    padded window whose pad mask is shared by all its windows (batched)."""
    tmodel = TwinSVT(**TWINS_CFG, device="cpu")
    TW.ROUTE_LOG = []
    try:
        with torch.no_grad():
            tmodel(torch.zeros(1, 32, 32, 3))
        routes = list(TW.ROUTE_LOG)
    finally:
        TW.ROUTE_LOG = None
    assert routes == ["fused_flat", "batched", "batched"]


def test_seeded_stochastic_depth_and_dropout(pair):
    name = pair[0]
    _, tcls, cfg, _ = MODELS[name]
    model = tcls(**cfg, drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.3,
                 device="cpu", seed=3)
    assert model.has_dropout
    model.train()
    x = torch.zeros(4, 32, 32, 3) + 0.5
    outs = []
    old, TW._pack_dropout_warned = TW._pack_dropout_warned, True
    try:
        for i in range(2):
            model.dropout_generator.manual_seed(7)
            torch.manual_seed(i)  # nothing draws from the global generator
            outs.append(model(x).detach())
        other = model(x).detach()  # the generator has moved on
    finally:
        TW._pack_dropout_warned = old
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(other, outs[0])
    last = "block4_0" if name == "pvt" else "block2_1"
    assert getattr(model, last).drop_path.rate == pytest.approx(0.3)
    first = "block1_0" if name == "pvt" else "block0_0"
    assert getattr(model, first).drop_path.rate == 0.0


def test_train_model_learns_and_takes_nchw(pair):
    from synthetic_data import SyntheticLoader

    name = pair[0]
    _, tcls, cfg, _ = MODELS[name]
    model = tcls(**dict(cfg, num_classes=4), device="cpu")
    data = SyntheticLoader(32, 16, 32, 4, seed=20)
    nchw = [(np.transpose(im, (0, 3, 1, 2)), lb) for im, lb in data]
    hist = model.train_model(model, nchw, nchw, 3, lr=2e-3, verbose=False)
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert hist["final_state"].step == 6 and not model.training


def test_export_load_predict_on_the_cpu(pair, tmp_path):
    name, jmodel, params, tmodel = pair
    _, tcls, cfg, _ = MODELS[name]
    manifest = serving.export_classifier(tmodel, (32, 32, 3), str(tmp_path),
                                         buckets=(1, 4))
    assert manifest["model"] == tcls.__name__
    assert json.loads(json.dumps(manifest)) == manifest
    clf = serving.load_classifier(str(tmp_path), device="cpu")
    assert type(clf.model) is tcls and not clf.model.training
    x = _randn(6, 6, 32, 32, 3)
    tfa.reset_launch_counts()
    clf.warmup()
    got = clf.predict(x)  # chunked 4 + padded 2 → 4
    assert got.shape == (6, 10) and not any(tfa.LAUNCHES.values())
    _close(got, _apply(jmodel, params, jnp.asarray(x)), TOL)


def _sizes(shapes, prefix=""):
    """(port name, size) of every leaf of a JAX params tree of shapes."""
    for key, sub in shapes.items():
        if isinstance(sub, dict):
            yield from _sizes(sub, f"{prefix}{key}.")
        else:
            yield prefix + {"kernel": "weight", "scale": "weight"}.get(
                key, key), int(np.prod(sub.shape))


@pytest.mark.parametrize("preset,name,millions", [
    ("pvt_tiny224_imagenet", "pvt", 13), ("twins_svts224_imagenet", "twins",
                                          24)])
def test_imagenet_presets_build_at_full_size(preset, name, millions):
    """Every parameter of the JAX model at full size (shapes only, traced
    abstractly) has its counterpart of the same size in the port, built on
    ``meta`` tensors; the presets are the JAX package's."""
    jcls, tcls, _, _ = MODELS[name]
    assert get_args(preset) == jget_args(preset)
    shapes = jax.eval_shape(
        jcls(**get_args(preset)).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))["params"]
    want = dict(_sizes(shapes))
    with torch.device("meta"):
        model = tcls(**get_args(preset), device="meta")
    got = {k: v.numel() for k, v in model.state_dict().items()}
    assert got == want and sum(got.values()) > millions * 1_000_000
    assert set(tcls(**dict(model.config, embed_dims=[8, 8, 8, 8][:len(
        model.config["depths"])], num_heads=[1] * len(model.config["depths"])),
        device="cpu").state_dict()) == set(got)
