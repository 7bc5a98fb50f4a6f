"""The PyTorch port's Swin and SwinV2 against the JAX package.

Same weights in both packages (JAX params, perturbed from a numpy seed so
that no bias or LayerNorm parameter stays at its initial 0 or 1, converted
by ``swin_state_dict_from_jax``), same numpy images, fp32 on the CPU, where
the port's window wrappers take their plain versions. JAX runs under the
highest matmul precision. Tolerance: 1e-4 on logits of O(1) after a whole
model, 1e-5 after one block.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import (
    swin_transformer as jswin,
)
from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformer,
    SwinTransformerBlock,
    SwinTransformerBlockV2,
    SwinTransformerV2,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import windows as TW
from vision_transformers_tpu_torch.utils.args import get_args
from vision_transformers_tpu_torch.utils.port_jax import swin_state_dict_from_jax

# two stages, narrow; 20 px / patch 2 → a 10×10 map (padded to 12 for the
# 4×4 windows) and a 5×5 one (padded to 8): both indivisible
NARROW = dict(patch_size=[2, 2], embed_dim=16, depths=[2, 2],
              num_heads=[2, 4], window_size=[4, 4], num_classes=10,
              stochastic_depth_prob=0.1)
SHAPE = (20, 20, 3)
TOL = 1e-4
PAIRS = {"v1": (jswin.SwinTransformer, SwinTransformer),
         "v2": (jswin.SwinTransformerV2, SwinTransformerV2)}


def _perturbed_params(module, seed, *inputs):
    params = jax.device_get(
        module.init(jax.random.PRNGKey(seed), *inputs)["params"])
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), params)


def _apply(module, params, *inputs):
    with jax.default_matmul_precision("highest"):
        return np.asarray(module.apply({"params": params}, *inputs))


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    jcls, tcls = PAIRS[request.param]
    jmodel = jcls(**NARROW)
    params = _perturbed_params(jmodel, 0, jnp.zeros((1, *SHAPE)))
    tmodel = tcls(**NARROW, device="cpu")
    result = tmodel.load_state_dict(swin_state_dict_from_jax(params),
                                    strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return request.param, jmodel, params, tmodel


def test_logits_match_jax(pair):
    _, jmodel, params, tmodel = pair
    x = np.random.RandomState(1).randn(3, *SHAPE).astype(np.float32)
    want = _apply(jmodel, params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_routes_of_the_narrow_model(pair):
    version, _, _, tmodel = pair
    TW.ROUTE_LOG = []
    try:
        with torch.no_grad():
            tmodel(torch.zeros(1, *SHAPE))
        routes = list(TW.ROUTE_LOG)
    finally:
        TW.ROUTE_LOG = None
    # 9 windows unshifted → batched; 4 windows (stage 2) → not batched
    assert routes == (["batched", "fused_flat", "fused_slab", "fused_slab"]
                      if version == "v1" else ["batched", "pack", "pack", "pack"])


def test_state_dict_names_mirror_the_jax_tree(pair):
    version, _, params, tmodel = pair
    sd = swin_state_dict_from_jax(params)
    assert set(sd) == set(tmodel.state_dict())
    assert sd["patch_embed.weight"].shape == (16, 2 * 2 * 3)
    attn = "stage1_block1.attn."
    assert sd[attn + "qkv_kernel"].shape == (32, 96)  # flax (in, out), kept
    if version == "v1":
        assert sd[attn + "relative_position_bias_table"].shape == (49, 4)
        assert sd[attn + "qkv_bias"].shape == (96,)
    else:
        assert sd[attn + "cpb_fc1.weight"].shape == (512, 2)
        assert sd[attn + "cpb_fc2.weight"].shape == (4, 512)
        assert sd[attn + "logit_scale"].shape == (4, 1, 1)
        assert attn + "cpb_fc2.bias" not in sd and attn + "qkv_bias" not in sd


def test_bf16_logits_close_to_jax_bf16(pair):
    """bf16 rounds every activation (8 significant bits) at steps that
    differ between the packages: held to 5% of the largest fp32 logit."""
    version, jmodel, params, _ = pair
    jcls, tcls = PAIRS[version]
    x = np.random.RandomState(2).randn(2, *SHAPE).astype(np.float32)
    want = _apply(jcls(**NARROW, dtype=jnp.bfloat16), params,
                  jnp.asarray(x)).astype(np.float32)
    tmodel = tcls(**NARROW, dtype="bfloat16", device="cpu")
    tmodel.load_state_dict(swin_state_dict_from_jax(params))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=0.05 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("shift", [(0, 0), (2, 2)])
def test_block_matches_jax(v2, shift):
    dim, heads, win = 16, 2, (4, 4)
    x = np.random.RandomState(3).randn(2, 8, 8, dim).astype(np.float32)
    jblock = (jswin.SwinTransformerBlockV2 if v2
              else jswin.SwinTransformerBlock)(dim, heads, win, shift)
    params = _perturbed_params(jblock, 4, jnp.asarray(x))
    want = _apply(jblock, params, jnp.asarray(x))
    tblock = (SwinTransformerBlockV2 if v2 else SwinTransformerBlock)(
        dim, heads, win, shift)
    tblock.load_state_dict(swin_state_dict_from_jax(params), strict=True)
    tblock.eval()
    with torch.no_grad():
        got = tblock(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_gradients_flow_on_the_cpu(pair):
    """Every parameter gets a finite gradient, through the window wrappers'
    autograd functions (on the CPU their backward is the plain version of
    the window backward kernel)."""
    _, _, _, tmodel = pair
    x = torch.from_numpy(
        np.random.RandomState(5).randn(2, *SHAPE).astype(np.float32))
    tmodel.zero_grad()
    tmodel(x).square().sum().backward()
    for name, p in tmodel.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    tmodel.zero_grad()


def test_training_mode_draws_seeded_dropout(monkeypatch):
    cfg = dict(NARROW, dropout=0.1, attention_dropout=0.1)
    model = SwinTransformer(**cfg, device="cpu", seed=3)
    model.train()
    x = torch.zeros(2, *SHAPE) + 0.5
    outs = []
    monkeypatch.setattr(TW, "_pack_dropout_warned", True)  # warned once elsewhere
    for i in range(2):
        model.dropout_generator.manual_seed(7)
        torch.manual_seed(i)  # nothing draws from the global generator
        outs.append(model(x).detach())
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])  # same seeds, same masks
    model.eval()
    with torch.no_grad():
        assert not torch.equal(model(x), outs[0])


def swin_state_dict_sizes(shapes, prefix=""):
    """(port name, abstract leaf) of every leaf of a JAX params tree."""
    for key, sub in shapes.items():
        if isinstance(sub, dict):
            yield from swin_state_dict_sizes(sub, f"{prefix}{key}.")
        else:
            yield prefix + {"kernel": "weight", "scale": "weight"}.get(
                key, key), sub


@pytest.mark.parametrize("version", list(PAIRS))
def test_export_load_predict_on_the_cpu(version, tmp_path):
    jcls, tcls = PAIRS[version]
    jmodel = jcls(**NARROW)
    params = _perturbed_params(jmodel, 6, jnp.zeros((1, *SHAPE)))
    model = tcls(**NARROW, device="cpu")
    model.load_state_dict(swin_state_dict_from_jax(params))
    manifest = serving.export_classifier(model, SHAPE, str(tmp_path),
                                         buckets=(1, 4))
    assert manifest["model"] == tcls.__name__
    assert manifest["model_kwargs"]["v2"] == (version == "v2")
    assert json.loads(json.dumps(manifest)) == manifest
    clf = serving.load_classifier(str(tmp_path), device="cpu")
    assert type(clf.model) is tcls
    x = np.random.RandomState(7).randn(6, *SHAPE).astype(np.float32)
    tfa.reset_launch_counts()
    clf.warmup()
    got = clf.predict(x)  # chunked 4 + padded 2 → 4
    assert got.shape == (6, 10) and not any(tfa.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(),
                               _apply(jmodel, params, jnp.asarray(x)),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("preset,version", [
    ("swint_224_imagenet", "v1"), ("swinv2t_224_imagenet", "v2")])
def test_imagenet_presets_build_at_full_size(preset, version):
    """Every parameter of the JAX model at full size (shapes only, traced
    abstractly) has its counterpart of the same size in the port."""
    jcls, cls = PAIRS[version]
    shapes = jax.eval_shape(
        jcls(**get_args(preset)).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))["params"]
    want = {k: int(np.prod(v.shape)) for k, v in swin_state_dict_sizes(shapes)}
    model = cls(**get_args(preset), device="cpu")
    got = {k: v.numel() for k, v in model.state_dict().items()}
    assert got == want and sum(got.values()) > 28_000_000
    assert model.config["window_size"] == get_args(preset)["window_size"]
    rebuilt = cls(**model.config, device="cpu")
    assert set(rebuilt.state_dict()) == set(model.state_dict())


def test_indivisible_image_raises():
    model = SwinTransformer(**NARROW, device="cpu")
    with pytest.raises(ValueError, match="indivisible"):
        model(torch.zeros(1, 21, 20, 3))
