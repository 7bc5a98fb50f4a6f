"""The port's TNT, CPVT and CPVTGAP against the JAX package.

Same weights in both packages: JAX params drawn with numpy into the shapes
``jax.eval_shape`` gives, converted by ``tnt_/cpvt_state_dict_from_jax`` and
loaded with ``strict=True``; same numpy inputs; fp32 on the CPU, where the
port's kernel wrappers take their plain versions. TNT at image 16, patch 8,
outer 64 with 4 heads and inner 24 with 2 heads (head dims 16 and 12, the
inner one a padded tile on the card), 2 layers; one variant with SE, qkv
biases and an inner-free layer. Tolerance: 1e-4 · max(1, max|ref|) on logits
and on every gradient at dropout 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import cpvt as jcpvt
from vision_transformers_tpu.models.image_classification import tnt as jtnt
from vision_transformers_tpu.training import trainer as jtrainer
from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import (
    CPVT,
    CPVTGAP,
    TNT,
)
from vision_transformers_tpu_torch.training import trainer as ttrainer
from vision_transformers_tpu_torch.utils import port_jax

TOL = 1e-4
_TNT = dict(image_size=16, patch_size=8, outer_dim=64, inner_dim=24,
            outer_num_heads=4, inner_num_heads=2, num_layers=2,
            num_classes=10)
_CPVT = dict(image_size=16, patch_size=4, num_layers=2, num_heads=2,
             hidden_dim=32, mlp_dim=64, num_classes=10)
MODELS = {
    # name: (JAX class, port class, kwargs, converter)
    "tnt": (jtnt.TNT, TNT, _TNT, port_jax.tnt_state_dict_from_jax),
    "tnt_se": (jtnt.TNT, TNT,
               dict(_TNT, se=1, qkv_bias=True, inner_free_layers=(1,)),
               port_jax.tnt_state_dict_from_jax),
    "cpvt": (jcpvt.CPVT, CPVT, _CPVT, port_jax.cpvt_state_dict_from_jax),
    "cpvtgap": (jcpvt.CPVTGAP, CPVTGAP, _CPVT,
                port_jax.cpvt_state_dict_from_jax),
}
SIDE = 16


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _draw_params(module, seed):
    """Numpy draws into the params shapes of ``module``: kernels
    N(0, 1/fan_in), scales 1 + N(0, 0.1), the rest N(0, 0.05)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIDE, SIDE, 3)))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1 + 0.1 * rng.randn(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(seed, n):
    return np.random.RandomState(seed).randn(n, SIDE, SIDE, 3).astype(
        np.float32)


def _close(got, want, what=""):
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(name, JAX model, params, port model, images, the JAX logits)."""
    jcls, tcls, cfg, convert = MODELS[request.param]
    jmodel = jcls(**cfg)
    params = _draw_params(jmodel, 0)
    tmodel = tcls(**cfg, device="cpu")
    result = tmodel.load_state_dict(convert(params), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    x = _images(1, 5)
    want = np.asarray(_jax(jax.jit(jmodel.apply), {"params": params},
                           jnp.asarray(x)))
    return request.param, jmodel, params, tmodel.eval(), x, want


def test_logits_match_jax(pair):
    _, _, _, tmodel, x, want = pair
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.shape == (5, 10) and np.abs(want).max() > 0.1
    _close(got.numpy(), want)


def test_gradients_match_jax(pair):
    """Loss and every parameter's gradient in training mode at dropout 0
    (the key part of a qk bias has a true gradient of 0 on both sides)."""
    name, jmodel, params, _, _, _ = pair
    convert = MODELS[name][3]
    rng = np.random.RandomState(3)
    x, y = _images(2, 4), rng.randint(0, 10, 4).astype(np.int32)
    w = np.ones(4, np.float32)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              deterministic=False)
        return jtrainer.cross_entropy_with_weights(
            logits, jnp.asarray(y), jnp.asarray(w))

    want_loss, grads = _jax(jax.jit(jax.value_and_grad(loss)), params)
    want_grads = convert(jax.device_get(grads))
    tmodel = MODELS[name][1](**MODELS[name][2], device="cpu")
    tmodel.load_state_dict(convert(params), strict=True)
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
        _close(grad.numpy(), want_grads[key].numpy(), key)


def test_state_dict_names_mirror_the_jax_tree(pair):
    name, _, params, tmodel, _, _ = pair
    sd = MODELS[name][3](params)
    assert set(sd) == set(tmodel.state_dict())
    if name.startswith("tnt"):
        assert sd["patch_proj.weight"].shape == (24, 3, 7, 7)
        assert sd["inner_pos"].shape == (1, 4, 24)
        assert sd["block0.inner_attn.qk.weight"].shape == (48, 24)
        assert sd["block0.proj.weight"].shape == (64, 96)
        assert "block0.proj.bias" not in sd
    if name == "tnt_se":
        assert sd["block0.se_layer.Dense_0.weight"].shape == (16, 64)
        assert "block1.inner_attn.qk.weight" not in sd  # inner-free
        assert sd["block0.outer_attn.qk.bias"].shape == (128,)
    if name.startswith("cpvt"):
        assert sd["pos_embedding.conv.weight"].shape == (32, 1, 3, 3)
        assert sd["encoder_layer_1.peg.conv.weight"].shape == (32, 1, 3, 3)


def test_tnt_attention_takes_the_split_head_route(monkeypatch):
    """TNT's attention goes through ``dot_product_attention`` with
    contiguous q, k and v at the head dims of its two granularities."""
    from vision_transformers_tpu_torch.models.image_classification import (
        tnt as ttnt,
    )

    seen = []
    real = ttnt.dot_product_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), q.is_contiguous(), k.is_contiguous(),
                     v.is_contiguous()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ttnt, "dot_product_attention", spy)
    model = TNT(**_TNT, device="cpu")
    with torch.no_grad():
        model(torch.from_numpy(_images(4, 2)))
    # per layer: inner (B·4 patches, 2 heads, 4 words, 12), outer (B, 4, 5, 16)
    assert seen == [((8, 2, 4, 12), True, True, True),
                    ((2, 4, 5, 16), True, True, True)] * 2


def test_dropout_is_seeded_by_the_model():
    """With dropout, attention dropout and stochastic depth the training
    forward is a function of ``dropout_generator``'s seed alone."""
    cfg = dict(_TNT, dropout=0.1, attention_dropout=0.1, drop_path_rate=0.2)
    x = torch.from_numpy(_images(5, 3))

    def run(seed):
        model = TNT(**cfg, device="cpu").train()
        model.dropout_generator.manual_seed(seed)
        return model(x)

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))


def test_export_load_predict_on_the_cpu(pair, tmp_path):
    _, _, _, tmodel, x, want = pair
    manifest = serving.export_classifier(tmodel, (SIDE, SIDE, 3),
                                         str(tmp_path), buckets=(1, 4))
    assert manifest["model"] == type(tmodel).__name__
    assert json.loads(json.dumps(manifest)) == manifest
    clf = serving.load_classifier(str(tmp_path), device="cpu")
    assert type(clf.model) is type(tmodel)
    _close(clf.predict(x).numpy(), want)
