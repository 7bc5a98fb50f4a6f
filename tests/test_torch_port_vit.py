"""The PyTorch port's ViT and its layers against the JAX package.

Same weights in both packages (JAX params converted by
``vit_state_dict_from_jax``), same numpy inputs, fp32 on the CPU.
Tolerances: 1e-5 for single layers, 1e-4 for logits after a whole model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu.ops import mlp as jmlp
from vision_transformers_tpu.ops import patch_embed as jpe
from vision_transformers_tpu.utils.args import _REGISTRY as J_REGISTRY
from vision_transformers_tpu.utils.args import get_args as jget_args
from vision_transformers_tpu_torch.core import initializers as tinit
from vision_transformers_tpu_torch.core.dtypes import as_dtype, resolve_device
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.ops import mlp as tmlp
from vision_transformers_tpu_torch.ops import patch_embed as tpe
from vision_transformers_tpu_torch.utils.args import _REGISTRY, get_args
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

TINY = dict(image_size=16, patch_size=4, num_layers=2, num_heads=4,
            hidden_dim=32, mlp_dim=64, num_classes=10)


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


def _init(module, seed, *inputs):
    return jax.device_get(module.init(jax.random.PRNGKey(seed), *inputs)
                          ["params"])


@pytest.mark.parametrize("jdtype,tdtype,tol", [
    (jnp.float32, torch.float32, 1e-6),
    # bf16: both round the same tanh-approximate GELU to bf16; allow one
    # bf16 ulp (2^-8 relative) for rounding at different steps
    (jnp.bfloat16, torch.bfloat16, 2 ** -7),
])
def test_gelu_for_matches_jax(jdtype, tdtype, tol):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = _np(jmlp.gelu_for(jdtype)(jnp.asarray(x, jdtype)))
    got = _np(tmlp.gelu_for(tdtype)(torch.from_numpy(x).to(tdtype)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_gelu_for_is_exact_in_fp32_and_tanh_in_bf16():
    x = torch.linspace(-3, 3, 61)
    assert torch.equal(tmlp.gelu_for(torch.float32)(x),
                       torch.nn.functional.gelu(x))
    xb = x.to(torch.bfloat16)
    assert torch.equal(tmlp.gelu_for(torch.bfloat16)(xb),
                       torch.nn.functional.gelu(xb, approximate="tanh"))


def test_mlp_block_matches_jax():
    x = _randn(0, 2, 9, 32)
    jmod = jmlp.MLPBlock(mlp_dim=64)
    params = _init(jmod, 0, jnp.asarray(x))
    tmod = tmlp.MLPBlock(32, 64)
    tmod.load_state_dict(vit_state_dict_from_jax(params))
    np.testing.assert_allclose(
        _np(tmod(torch.from_numpy(x))),
        _np(jmod.apply({"params": params}, jnp.asarray(x))),
        atol=1e-5, rtol=0)


def test_patchify_matches_jax():
    x = _randn(1, 2, 8, 12, 3)
    np.testing.assert_array_equal(
        _np(tpe.patchify(torch.from_numpy(x), 4)),
        _np(jpe.patchify(jnp.asarray(x), 4)))


def test_patch_embed_matches_jax():
    x = _randn(2, 2, 16, 16, 3)
    jmod = jpe.PatchEmbed(embed_dim=32, patch_size=4)
    params = _init(jmod, 1, jnp.asarray(x))
    params["proj"]["bias"] = _randn(3, 32, scale=0.1)
    tmod = tpe.PatchEmbed(32, 4, 3)
    tmod.load_state_dict(vit_state_dict_from_jax(params))
    (jt, jgrid), (tt, tgrid) = (jmod.apply({"params": params}, jnp.asarray(x)),
                                tmod(torch.from_numpy(x)))
    assert tgrid == jgrid == (4, 4)
    np.testing.assert_allclose(_np(tt), _np(jt), atol=1e-5, rtol=0)


def test_patchify_rejects_indivisible_image():
    with pytest.raises(ValueError, match="indivisible"):
        tpe.patchify(torch.zeros(1, 10, 12, 3), 4)


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny JAX ViT with every parameter set from numpy (a nonzero
    head), and the port's ViT loaded with the same weights."""
    jmodel = JViT(**TINY)
    params = _init(jmodel, 0, jnp.zeros((1, 16, 16, 3)))
    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.randn(*np.shape(a)) * 0.05).astype(
            np.float32), params)
    tmodel = ViT(**TINY, device="cpu")
    tmodel.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel


def test_vit_logits_match_jax(tiny_pair):
    jmodel, params, tmodel = tiny_pair
    x = _randn(5, 3, 16, 16, 3)
    want = _np(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = _np(tmodel(torch.from_numpy(x)))
    assert got.shape == (3, 10) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vit_forward_features_match_jax(tiny_pair):
    jmodel, params, tmodel = tiny_pair
    x = _randn(6, 2, 16, 16, 3)
    want = _np(jmodel.apply({"params": params}, jnp.asarray(x),
                            method=JViT.forward_features))
    got = _np(tmodel.forward_features(torch.from_numpy(x)))
    assert got.shape == (2, 17, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vit_return_weights_match_jax(tiny_pair):
    jmodel, params, tmodel = tiny_pair
    x = _randn(7, 2, 16, 16, 3)
    jl, jw = jmodel.apply({"params": params}, jnp.asarray(x),
                          return_weights=True)
    tl, tw = tmodel(torch.from_numpy(x), return_weights=True)
    assert len(tw) == len(jw) == 2
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=0)


def test_state_dict_names_mirror_jax_tree(tiny_pair):
    _, params, tmodel = tiny_pair
    assert set(vit_state_dict_from_jax(params)) == set(tmodel.state_dict())
    sd = vit_state_dict_from_jax(params)
    k = params["encoder"]["encoder_layer_1"]["self_attention"]["qkv"]["kernel"]
    np.testing.assert_array_equal(
        _np(sd["encoder.encoder_layer_1.self_attention.qkv.weight"]), k.T)


def test_vit_bf16_runs_close_to_fp32(tiny_pair):
    _, params, _ = tiny_pair
    m16 = ViT(**TINY, dtype="bfloat16", device="cpu")
    m16.load_state_dict(vit_state_dict_from_jax(params))
    m32 = ViT(**TINY, device="cpu")
    m32.load_state_dict(vit_state_dict_from_jax(params))
    x = torch.from_numpy(_randn(8, 2, 16, 16, 3))
    out16 = m16(x)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out16), _np(m32(x)), atol=0.1, rtol=0)


def test_vit_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViT(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_vit_rejects_unported_options():
    # quant8 is ported (the int8 serving model): its encoder Dense layers are
    # QuantDense, the patch embedding and head stay float, and it records
    # quant8 in its config; its numerics are in test_torch_port_quant.py
    q = ViT(**TINY, quant8=True, device="cpu")
    assert q.config["quant8"] and q.quant8
    assert q.encoder.encoder_layer_0.mlp.fc1.kernel_q.dtype == torch.int8
    assert q.head.weight.dtype == torch.float32
    with pytest.raises(ValueError):
        ViT(**{**TINY, "image_size": 18}, device="cpu")


def test_vit_starts_in_eval_mode_and_seed_fixes_weights():
    a, b = ViT(**TINY, device="cpu", seed=3), ViT(**TINY, device="cpu", seed=3)
    assert not a.training
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    c = ViT(**TINY, device="cpu", seed=4)
    assert not torch.equal(c.encoder.pos_embedding, a.encoder.pos_embedding)


def test_args_registry_is_a_faithful_copy():
    assert _REGISTRY == J_REGISTRY
    for name in ("vitb16_224_imagenet", "vit_tiny_cifar100",
                 "deit_base_cifar10"):
        assert get_args(name) == jget_args(name)
    with pytest.raises(KeyError):
        get_args("nope_cifar100")


def test_initializer_distributions():
    g = torch.Generator().manual_seed(0)
    t = tinit.trunc_normal_(torch.empty(200_000), 0.02, g)
    assert t.abs().max() <= 2 * 0.02 / tinit._TRUNC_STD + 1e-6
    assert abs(t.std().item() - 0.02) < 5e-4
    w = tinit.xavier_uniform_(torch.empty(300, 100), g)
    bound = (6 / 400) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    p = tinit.conv_patch_(torch.empty(48, 100_000), 4, 3, g)
    assert abs(p.std().item() - (1 / 48) ** 0.5) < 2e-3


def test_as_dtype_names():
    assert as_dtype("bfloat16") is torch.bfloat16
    assert as_dtype(torch.float32) is torch.float32
    with pytest.raises(ValueError):
        as_dtype("float99")
