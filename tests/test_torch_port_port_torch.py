"""The port's checkpoint import (``utils/port_torch.py``) against the JAX
package's.

Each converter of the port runs on a reference-layout torch ``state_dict``
built in the test (the torch modules of ``tests/test_port_torch.py``, with
the reference's exact names), and must give, key for key and bit for bit,
what the JAX converter's flax tree gives once carried into the port by
``utils.port_jax``: ``port.X(sd) == port_jax.*_state_dict_from_jax(jport.X(sd))``.
The ViT and Swin results load into the port's models with ``strict=True``;
one ViT logit check against the torch reference model on top (fp32, 2e-4 as
the JAX test). No JAX init of DETR (37 s on the CPU); nothing is downloaded.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_port_torch import (
    RefViT,
    TorchResNet50,
    TorchSwin,
    _fake_detr_state_dict,
    _randomize_bn_stats,
)
from vision_transformers_tpu.utils import port_torch as jport
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformer,
    SwinTransformerV2,
    ViT,
)
from vision_transformers_tpu_torch.utils import port_jax
from vision_transformers_tpu_torch.utils import port_torch as port


def _assert_same(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def _via_jax(convert, *args, **kwargs):
    return jax.device_get(convert(*args, **kwargs))


def _swin_v2_state_dict(dim=16, heads=2, seed=5):
    """A torchvision SwinV2 state_dict of one stage of one block (the layout
    of ``tests/test_port_torch.py::test_port_swin_v2_attention_params``)."""
    rng = np.random.RandomState(seed)
    f = lambda *sh: rng.randn(*sh).astype(np.float32)
    qkv_b = f(3 * dim)
    qkv_b[dim:2 * dim] = 0.0  # torchvision zeroes the k third
    sd = {"features.0.0.weight": f(dim, 3, 2, 2), "features.0.0.bias": f(dim),
          "features.0.2.weight": 1 + 0.1 * f(dim),
          "features.0.2.bias": f(dim)}
    p = "features.1.0"
    for n in ("norm1", "norm2"):
        sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = 1 + 0.1 * f(dim), f(dim)
    sd.update({
        f"{p}.attn.qkv.weight": f(3 * dim, dim), f"{p}.attn.qkv.bias": qkv_b,
        f"{p}.attn.proj.weight": f(dim, dim), f"{p}.attn.proj.bias": f(dim),
        f"{p}.attn.logit_scale": np.log(10.0) + 0.1 * f(heads, 1, 1),
        f"{p}.attn.cpb_mlp.0.weight": f(512, 2),
        f"{p}.attn.cpb_mlp.0.bias": f(512),
        f"{p}.attn.cpb_mlp.2.weight": f(heads, 512),
        f"{p}.mlp.0.weight": f(4 * dim, dim), f"{p}.mlp.0.bias": f(4 * dim),
        f"{p}.mlp.3.weight": f(dim, 4 * dim), f"{p}.mlp.3.bias": f(dim),
        "norm.weight": 1 + 0.1 * f(dim), "norm.bias": f(dim),
        "head.weight": f(10, dim), "head.bias": f(10)})
    return sd


def test_port_vit_state_dict_matches_jax_and_the_reference_logits():
    torch.manual_seed(0)
    tm = RefViT(32, 8, 2, 4, 64, 128, 10).eval()
    got = port.port_vit_state_dict(tm.state_dict())
    _assert_same(got, port_jax.vit_state_dict_from_jax(
        _via_jax(jport.port_vit_state_dict, tm.state_dict())))
    model = ViT(image_size=32, patch_size=8, num_layers=2, num_heads=4,
                hidden_dim=64, mlp_dim=128, num_classes=10, device="cpu")
    model.load_state_dict(got)
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))
        out = model(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()))
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("drop_reduction_bias", [False, True])
def test_port_swin_state_dict_matches_jax(drop_reduction_bias):
    torch.manual_seed(1)
    depths = [2, 1]
    sd = TorchSwin(2, 16, depths, [2, 4], (4, 4), 10).state_dict()
    if drop_reduction_bias:  # torchvision's PatchMerging has no bias
        del sd["features.2.reduction.bias"]
    got = port.port_swin_state_dict(sd, depths)
    _assert_same(got, port_jax.swin_state_dict_from_jax(
        _via_jax(jport.port_swin_state_dict, sd, depths)))
    if drop_reduction_bias:
        assert not got["merge0.reduction.bias"].any()
    SwinTransformer(patch_size=[2, 2], embed_dim=16, depths=depths,
                    num_heads=[2, 4], window_size=[4, 4], num_classes=10,
                    image_size=16, device="cpu").load_state_dict(got)


def test_port_swin_v2_state_dict_matches_jax():
    sd = _swin_v2_state_dict()
    got = port.port_swin_state_dict(sd, [1], v2=True)
    _assert_same(got, port_jax.swin_state_dict_from_jax(
        _via_jax(jport.port_swin_state_dict, sd, [1], v2=True)))
    qkv_b = torch.from_numpy(sd["features.1.0.attn.qkv.bias"])
    assert torch.equal(got["stage0_block0.attn.q_bias"], qkv_b[:16])
    assert torch.equal(got["stage0_block0.attn.v_bias"], qkv_b[32:])
    model = SwinTransformerV2(patch_size=[2, 2], embed_dim=16, depths=[1],
                              num_heads=[2], window_size=[4, 4],
                              num_classes=10, image_size=8, device="cpu")
    model.load_state_dict(got)
    with torch.no_grad():
        out = model(torch.from_numpy(
            np.random.RandomState(6).randn(2, 8, 8, 3).astype(np.float32)))
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("prefix", ["", "backbone.0.body."])
def test_port_resnet50_state_dict_matches_jax(prefix):
    body = TorchResNet50(stage_sizes=(1, 2, 1, 1))
    with torch.no_grad():
        _randomize_bn_stats(body, seed=2)
    sd = {f"{prefix}{k}": v for k, v in body.state_dict().items()}
    sd["class_embed.weight"] = torch.zeros(1)  # not the backbone's: ignored
    got = port.port_resnet50_state_dict(sd)
    _assert_same(got, port_jax.detr_state_dict_from_jax(
        _via_jax(jport.port_resnet50_state_dict, sd)))
    assert "layer2_block1.conv3.weight" in got
    assert "layer2_block1.down_conv.weight" not in got


def test_port_detr_state_dict_matches_jax():
    """Full ResNet-50, narrow transformer; the strict load of a full-width
    facebook-layout checkpoint into ``Detr`` is in
    ``test_torch_port_cli.py`` (``run_detection_main(init_from_torch=)``)."""
    sd = _fake_detr_state_dict(stage_sizes=(3, 4, 6, 3))
    got = port.port_detr_state_dict({"model": sd})  # the published wrapper
    _assert_same(got, port_jax.detr_state_dict_from_jax(
        _via_jax(jport.port_detr_state_dict, sd)))
    w = torch.from_numpy(
        sd["transformer.encoder.layers.0.self_attn.in_proj_weight"])
    assert torch.equal(got["transformer.encoder.layer0.self_attn.k_proj."
                           "weight"], w[32:64])
    with pytest.raises(KeyError, match="transformer.encoder.layers"):
        port.port_detr_state_dict({"query_embed.weight": 0})


@pytest.mark.parametrize("kind", ["pt", "pt_state_dict", "pt_model", "npz"])
def test_load_torch_checkpoint_matches_jax(tmp_path, kind):
    torch.manual_seed(3)
    tm = RefViT(32, 8, 1, 2, 32, 64, 10)
    sd = tm.state_dict()
    path = tmp_path / ("vit.npz" if kind == "npz" else "vit.pt")
    if kind == "npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        wrap = {"pt": lambda d: d, "pt_state_dict": lambda d: {"state_dict": d},
                "pt_model": lambda d: {"model": d}}[kind]
        torch.save(wrap(sd), path)
    got = port.load_torch_checkpoint(str(path), "vit_tiny_cifar10",
                                     {"image_size": 32})
    _assert_same(got, port_jax.vit_state_dict_from_jax(_via_jax(
        jport.load_torch_checkpoint, str(path), "vit_tiny_cifar10",
        {"image_size": 32})))


def test_load_torch_checkpoint_swin_routing_and_messages(tmp_path):
    torch.manual_seed(4)
    sd = TorchSwin(2, 16, [1, 1], [2, 2], (4, 4), 10).state_dict()
    path = tmp_path / "swin.npz"
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    got = port.load_torch_checkpoint(str(path), "swin_tiny_cifar10",
                                     {"depths": [1, 1]})
    assert "stage1_block0.attn.qkv_kernel" in got and "merge0.norm.weight" in got
    with pytest.raises(ValueError, match="no torch porting rule"):
        port.load_torch_checkpoint(str(path), "tnt_base_cifar10", {})
    with pytest.raises(KeyError, match="is missing 'encoder.pos_embedding'"):
        port.port_vit_state_dict({"encoder.layers.encoder_layer_0.x": 0})
    with pytest.raises(KeyError, match="encoder_layer_"):
        port.port_vit_state_dict({"conv_proj.weight": 0})
    for key in ("vit_tiny_cifar100", "swin_tinv2_cifar100", "TNT_cifar10"):
        assert port.parse_model_key(key) == jport.parse_model_key(key)
