"""The port's DeiT, CPE-ViT and T2T-ViT (both token types) against the JAX
package, with ``USE_FUSED_BLOCK`` off and on.

Same weights in both packages: JAX params drawn with numpy into the shapes
``jax.eval_shape`` gives (``init`` of a T2T is slow on the CPU), converted
by ``deit_/cpevit_/t2t_state_dict_from_jax`` and loaded with
``strict=True``; same numpy inputs; fp32 on the CPU, where the port's
kernel wrappers take their plain versions. JAX runs under the highest
matmul precision and never fuses off a TPU, so the port's flag-on models
are held against the same JAX models. Tolerance: 1e-4 on logits, losses
and gradients of O(1) after a whole model.

The T2T performers drop at 0.1 in training in both packages whatever the
model's ``dropout`` (``TokenPerformer``'s defaults, which ``T2T`` does not
override); their masks come from different generators, so the training
comparison sets both packages' performer rates to 0 (the JAX module through
a ``functools.partial`` of its class) and the port's seeded dropout is
tested within the port.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_transformers_tpu.models.image_classification import cpe_vit as jcpe
from vision_transformers_tpu.models.image_classification import deit as jdeit
from vision_transformers_tpu.models.image_classification import t2t_vit as jt2t
from vision_transformers_tpu.models.image_classification import (
    token_performer as jtp,
)
from vision_transformers_tpu.ops import patch_embed as jpe
from vision_transformers_tpu.training import optimizers as jopt
from vision_transformers_tpu.training import trainer as jtrainer
from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import (
    CPEViT,
    DeiT,
    T2T_ViT,
)
from vision_transformers_tpu_torch.models.image_classification import (
    vanilla_vit as tvit,
)
from vision_transformers_tpu_torch.models.image_classification.t2t_vit import (
    soft_split,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops.layers import Dropout
from vision_transformers_tpu_torch.ops.patch_embed import OverlapPatchEmbed
from vision_transformers_tpu_torch.training import trainer as ttrainer
from vision_transformers_tpu_torch.utils import port_jax

TOL = 1e-4
T2T = dict(image_size=32, patch_size=16, num_layers=2, num_heads=2,
           hidden_dim=32, mlp_dim=64, num_classes=10, token_dim=16)
MODELS = {
    # name: (JAX class, port class, kwargs, converter, image side)
    "deit": (jdeit.DeiT, DeiT, dict(image_size=16, patch_size=4, num_layers=2,
                                    num_heads=2, embed_dim=32, num_classes=10),
             port_jax.deit_state_dict_from_jax, 16),
    "deit_pad": (jdeit.DeiT, DeiT, dict(image_size=14, patch_size=4,
                                        num_layers=1, num_heads=2,
                                        embed_dim=32, num_classes=10),
                 port_jax.deit_state_dict_from_jax, 14),
    "cpevit": (jcpe.CPEViT, CPEViT, dict(image_size=16, patch_size=4,
                                         num_layers=2, num_heads=2,
                                         hidden_dim=32, mlp_dim=64,
                                         num_classes=10),
               port_jax.cpevit_state_dict_from_jax, 16),
    "t2t_performer": (jt2t.T2T_ViT, T2T_ViT, T2T,
                      port_jax.t2t_state_dict_from_jax, 32),
    "t2t_transformer": (jt2t.T2T_ViT, T2T_ViT,
                        dict(T2T, token_type="transformer"),
                        port_jax.t2t_state_dict_from_jax, 32),
}


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _draw_params(module, seed, side):
    """Numpy draws into the params shapes of ``module``: kernels
    N(0, 1/fan_in), scales 1 + N(0, 0.1), the performer's ``w`` orthogonal
    rows × √m (its JAX init), the rest N(0, 0.05)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 3)))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1 + 0.1 * rng.randn(*shape)
        elif name == "w":
            q, _ = np.linalg.qr(rng.randn(shape[1], shape[0]))
            a = q.T * np.sqrt(shape[0])
        else:
            a = 0.05 * rng.randn(*shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(seed, n, side):
    return np.random.RandomState(seed).randn(n, side, side, 3).astype(
        np.float32)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(name, JAX model, params, port model, images (5, side, side, 3), the
    JAX logits of those images: one jitted JAX forward per model)."""
    jcls, tcls, cfg, convert, side = MODELS[request.param]
    jmodel = jcls(**cfg)
    params = _draw_params(jmodel, 0, side)
    tmodel = tcls(**cfg, device="cpu")
    result = tmodel.load_state_dict(convert(params), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    x = _images(1, 5, side)
    want = np.asarray(_jax(jax.jit(jmodel.apply), {"params": params},
                           jnp.asarray(x)))
    return request.param, jmodel, params, tmodel.eval(), x, want


@pytest.mark.parametrize("fused", [False, True])
def test_logits_match_jax(pair, fused, monkeypatch):
    name, _, _, tmodel, x, want = pair
    monkeypatch.setattr(tvit, "USE_FUSED_BLOCK", fused)
    calls = []
    real = tvit.fused_attention_block
    monkeypatch.setattr(tvit, "fused_attention_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.shape == (5, 10) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    layers = MODELS[name][2]["num_layers"]
    assert len(calls) == (layers if fused else 0)


def _zero_performer_dropout(tmodel):
    for m in tmodel.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0


@pytest.mark.parametrize("name", [n for n in MODELS if n != "deit_pad"])
def test_one_train_step_matches_jax(name, monkeypatch):
    """Loss, every parameter's gradient and the parameters after one Adam
    step (lr 1e-3) through both packages' ``train_step_fn``, in training
    mode at dropout 0 (the performers' too, see the module docstring).
    Adam's first step is lr·sign(g): where |g| is within rounding noise of
    0 (the key third of ``qkv.bias``, whose true gradient is 0, and chance
    zeros) its sign is noise, so those elements are left out of the
    parameter comparison."""
    jcls, tcls, cfg, convert, side = MODELS[name]
    if name == "t2t_performer":
        monkeypatch.setattr(jt2t, "TokenPerformer", functools.partial(
            jtp.TokenPerformer, dp1=0.0, dp2=0.0))
    jmodel = jcls(**cfg)
    params = _draw_params(jmodel, 0, side)
    rng = np.random.RandomState(3)
    x, y = _images(2, 4, side), rng.randint(0, 10, 4).astype(np.int32)
    w = np.ones(4, np.float32)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              deterministic=False)
        return jtrainer.cross_entropy_with_weights(
            logits, jnp.asarray(y), jnp.asarray(w))

    want_loss, grads = _jax(jax.jit(jax.value_and_grad(loss)), params)
    want_grads = convert(jax.device_get(grads))
    # the JAX trainer's step: its optimizer's update of these gradients
    tx = jopt.make_optimizer("adam", 1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    want_after = convert(jax.device_get(optax.apply_updates(params, updates)))

    tmodel = tcls(**cfg, device="cpu")
    tmodel.load_state_dict(convert(params), strict=True)
    _zero_performer_dropout(tmodel)
    tmodel.train()
    got_loss = ttrainer.cross_entropy_with_weights(
        tmodel(torch.from_numpy(x)), torch.from_numpy(y).long(),
        torch.from_numpy(w))
    got_loss.backward()
    assert abs(got_loss.item() - float(want_loss)) <= TOL
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want_grads)
    for key, p in named.items():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(grad.numpy(), want_grads[key], atol=TOL,
                                   rtol=0, err_msg=key)
    tmodel.zero_grad()
    state = ttrainer.make_train_state(tmodel, lr=1e-3)
    state, loss_n, _, n = ttrainer.train_step_fn(tmodel)(state, x, y, w)
    assert abs((loss_n / n).item() - float(want_loss)) <= TOL
    for key, p in tmodel.named_parameters():
        sure = np.abs(want_grads[key].numpy()) > 1e-5
        np.testing.assert_allclose(p.detach().numpy()[sure],
                                   want_after[key].numpy()[sure], atol=TOL,
                                   rtol=0, err_msg=key)


def test_export_load_predict_on_the_cpu(pair, tmp_path):
    name, _, _, tmodel, x, want = pair
    side = MODELS[name][4]
    manifest = serving.export_classifier(tmodel, (side, side, 3),
                                         str(tmp_path), buckets=(1, 4))
    assert manifest["model"] == type(tmodel).__name__
    assert json.loads(json.dumps(manifest)) == manifest
    clf = serving.load_classifier(str(tmp_path), device="cpu")
    assert type(clf.model) is type(tmodel) and not clf.model.training
    tfa.reset_launch_counts()
    clf.warmup()
    got = clf.predict(x)  # chunked 4 + padded 1 → 4
    assert got.shape == (5, 10) and not any(tfa.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_state_dict_names_mirror_the_jax_tree(pair):
    name, _, params, tmodel, _, _ = pair
    sd = MODELS[name][3](params)
    assert set(sd) == set(tmodel.state_dict())
    if name == "deit":
        assert sd["pos_embed"].shape == (1, 16 + 2, 32)
        assert {"dist_token", "head_dist.weight", "norm_f.weight",
                "block1.self_attention.qkv.weight"} <= set(sd)
    if name == "deit_pad":
        assert sd["pos_embed"].shape == (1, 16 + 2, 32)  # 14 px → 4 × 4
    if name == "cpevit":
        assert sd["pos_embedding.conv.weight"].shape == (32, 1, 3, 3)
    if name == "t2t_performer":
        assert sd["t2t.attention1.w"].shape == (8, 16)
        assert sd["t2t.attention1.kqv.weight"].shape == (48, 3 * 49)
        assert sd["t2t.project.weight"].shape == (32, 16 * 9)
    if name == "t2t_transformer":
        assert sd["t2t.attention2.attn.qkv.weight"].shape == (48, 16 * 9)
        assert "t2t.attention2.attn.qkv.bias" not in sd


def test_soft_split_orders_features_as_jax():
    """(C, kh, kw) feature order (``conv_general_dilated_patches``), not
    ``patchify``'s (kh, kw, C); non-square input."""
    x = np.random.RandomState(5).randn(2, 9, 7, 4).astype(np.float32)
    for k, s, p in ((3, 2, 1), (7, 4, 2), (3, 1, 0)):
        want, wgrid = jt2t.soft_split(jnp.asarray(x), k, s, p)
        got, grid = soft_split(torch.from_numpy(x), k, s, p)
        assert grid == wgrid
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overlap_patch_embed_matches_jax():
    jm = jpe.OverlapPatchEmbed(embed_dim=12, kernel_size=7, stride=4,
                               padding=2)
    x = _images(6, 2, 20)
    params = _draw_params(jm, 7, 20)
    want, wgrid = _jax(jm.apply, {"params": params}, jnp.asarray(x))
    tm = OverlapPatchEmbed(12, 7, 4, 2)
    tm.load_state_dict(port_jax.detr_state_dict_from_jax(params), strict=True)
    got, grid = tm(torch.from_numpy(x))
    assert grid == tuple(wgrid) == (5, 5) and got.shape == (2, 25, 12)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_deit_heads_and_distillation_surface():
    model = DeiT(**dict(MODELS["deit"][2], distilled_training=True),
                 device="cpu")
    for p in (model.head.weight, model.head_dist.bias):
        torch.nn.init.normal_(p)
    x = torch.from_numpy(_images(8, 2, 16))
    model.train()
    cls, dist = model(x)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), (cls + dist) / 2)
    with pytest.raises(ValueError, match="teacher"):
        model.train_model_with_distillation(None, None, 1)


def test_t2t_performer_dropout_is_seeded_by_the_model():
    """At ``dropout=0`` the performers still drop in training (0.1); the
    masks come from ``dropout_generator`` and from nothing else."""
    model = T2T_ViT(**T2T, device="cpu", seed=1)
    assert model.has_dropout
    torch.nn.init.normal_(model.head.weight)
    x = torch.from_numpy(_images(9, 2, 32))
    model.train()
    outs = []
    for i in range(2):
        model.dropout_generator.manual_seed(4)
        torch.manual_seed(i)  # nothing draws from the global generator
        outs.append(model(x).detach())
    other = model(x).detach()
    assert torch.equal(outs[0], outs[1]) and not torch.equal(other, outs[0])
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x), model(x))
    assert not T2T_ViT(**dict(T2T, token_type="transformer"),
                       device="cpu").has_dropout
