"""The port's int8 (w8a8) serving path against the JAX package on the CPU.

``ops/quant.py`` against JAX ``ops/quant.py`` on the same numpy inputs,
bit-equal: the int8 product is exact in int32 in both packages, and every
float step (the per-row scale, the rounding, the rank-1 rescale, the bias)
is the same fp32 operation in the same order. ``serving.quantize_classifier``
on the weights of a JAX ViT against JAX's: the same int8 weights and scales
(bit-equal) and the quantized logits, head non-zero, within
1e-4 · max(1, max|ref|) (the float parts of the two forwards round
differently, and an activation that lands on a rounding boundary of the
int8 grid moves by one step). The JAX package's own round trip and its
``ValueError``, the fused gate under ``quant8`` and the trainer's refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import serving as jserving
from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu.ops import quant as jquant
from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformer,
    ViT,
)
from vision_transformers_tpu_torch.models.image_classification import (
    vanilla_vit as vv,
)
from vision_transformers_tpu_torch.ops import quant
from vision_transformers_tpu_torch.ops.layers import Dense
from vision_transformers_tpu_torch.training import trainer
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

SHAPE = (32, 32, 3)
CFG = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
           hidden_dim=64, mlp_dim=128, num_classes=10)


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _x(seed, *shape, zero_rows=()):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x[list(zero_rows)] = 0.0
    return x


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_dynamic_quant_rows_bit_equal(jdt, tdt):
    x = _x(0, 6, 40, zero_rows=(2,))
    jq, js = jquant.dynamic_quant_rows(jnp.asarray(x, jdt))
    tq, ts = quant.dynamic_quant_rows(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert not _np(tq)[2].any()  # a zero row quantizes to 0 exactly


def test_quantize_kernel_and_dense_params_bit_equal():
    w = _x(1, 24, 16) * 0.05                    # torch layout (out, in)
    w[3] = 0.0                                  # a zero output channel
    jq, js = jquant.quantize_kernel(jnp.asarray(w.T))
    tq, ts = quant.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq).T)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    dense = Dense(16, 24)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w))
    got = quant.quantize_dense_params(dense)
    want = jquant.quantize_dense_params(
        {"kernel": jnp.asarray(w.T), "bias": jnp.zeros(24)})
    assert set(got) == set(want) == {"kernel_q", "kernel_scale", "bias"}
    np.testing.assert_array_equal(_np(got["kernel_q"]),
                                  np.asarray(want["kernel_q"]).T)


@pytest.mark.parametrize("lead,bias,out_dtype", [
    ((5,), True, None), ((2, 3), False, None), ((4,), True, "bfloat16")])
def test_int8_matmul_bit_equal(lead, bias, out_dtype):
    x = _x(2, int(np.prod(lead)), 32, zero_rows=(1,)).reshape(*lead, 32)
    w = _x(3, 16, 32) * 0.1
    b = _x(4, 16) * 0.1 if bias else None
    jq, js = jquant.quantize_kernel(jnp.asarray(w.T))
    want = jquant.int8_matmul(
        jnp.asarray(x), jq, js, None if b is None else jnp.asarray(b),
        out_dtype=None if out_dtype is None else jnp.dtype(out_dtype))
    tq, ts = quant.quantize_kernel(torch.from_numpy(w))
    quant.reset_product_counts()
    got = quant.int8_matmul(
        torch.from_numpy(x), tq, ts, None if b is None else torch.from_numpy(b),
        out_dtype=None if out_dtype is None else getattr(torch, out_dtype))
    assert quant.PRODUCTS["int8_matmul"] == 1
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got.float()),
                                  np.asarray(want, np.float32))
    zero = _np(got.float()).reshape(-1, 16)[1]
    np.testing.assert_array_equal(zero, 0.0 if b is None else
                                  np.asarray(b, np.float32).astype(
                                      out_dtype or np.float32))


def test_quant_dense_state_mirrors_the_jax_module():
    jparams = jquant.QuantDense(8).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 16)))["params"]
    qd = quant.QuantDense(16, 8)
    state = qd.state_dict()
    assert set(state) == set(jparams)
    for k, v in jparams.items():
        want_shape = v.shape[::-1] if k == "kernel_q" else v.shape
        assert tuple(state[k].shape) == want_shape, k
        assert str(state[k].dtype).removeprefix("torch.") == str(v.dtype), k
    qd.to(torch.bfloat16)  # a module-wide cast never reaches the int8 kernel
    assert qd.kernel_q.dtype == torch.int8
    assert "bias" not in quant.QuantDense(16, 8, bias=False).state_dict()


@pytest.fixture(scope="module")
def models():
    """A JAX ViT with a non-zero head, quantized by JAX, and the port's ViT
    loaded with its float weights."""
    jmodel = JViT(**CFG)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE))))["params"]
    rng = np.random.RandomState(5)
    # numpy draws into the init's shapes (flax's op-by-op init is slow on
    # the CPU): LayerNorm scales about 1, everything else N(0, 0.1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (1.0 + 0.1 * rng.randn(*s.shape)
                         if path[-1].key == "scale"
                         else 0.1 * rng.randn(*s.shape)).astype(np.float32),
        shapes)
    jq_model, jq_params = jserving.quantize_classifier(jmodel, params)
    model = ViT(**CFG, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params))
    return jq_model, jax.device_get(jq_params), model


def test_quantize_classifier_matches_jax(models):
    jq_model, jq_params, model = models
    qmodel = serving.quantize_classifier(model)
    assert qmodel.quant8 and type(qmodel) is ViT and not qmodel.training
    want = vit_state_dict_from_jax(jq_params)  # int8 leaves kept int8
    got = qmodel.state_dict()
    assert set(got) == set(want)
    n_int8 = 0
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        assert torch.equal(v, want[k]), k
        n_int8 += v.dtype == torch.int8
    assert n_int8 == 4 * CFG["num_layers"]
    # the same state loads into a quant8 model built from the JAX tree
    carried = ViT(**CFG, quant8=True, device="cpu")
    carried.load_state_dict(want)
    x = _x(7, 4, *SHAPE)
    ref = np.asarray(jax.jit(jq_model.apply)({"params": jq_params},
                                             jnp.asarray(x)))
    with torch.no_grad():
        out = _np(qmodel(torch.from_numpy(x)))
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    assert np.abs(ref).max() > 0.1  # the head is non-zero


def test_quantized_export_round_trip(models, tmp_path):
    _, _, model = models
    qmodel = serving.quantize_classifier(model)
    manifest = serving.export_classifier(qmodel, SHAPE, str(tmp_path),
                                         buckets=(4,))
    assert manifest["model_kwargs"]["quant8"] is True
    weights = torch.load(tmp_path / "weights.pt", weights_only=True)
    assert sum(v.dtype == torch.int8 for v in weights.values()) == 8
    clf = serving.load_classifier(str(tmp_path), device="cpu")
    x = _x(8, 4, *SHAPE)
    with torch.no_grad():
        want = qmodel(torch.from_numpy(x))
    # the JAX test's tolerance; the artifact runs the very same CPU code
    torch.testing.assert_close(clf.predict(x), want, rtol=2e-5, atol=2e-5)


def test_unsupported_model_raises():
    class NoQuant:
        pass

    with pytest.raises(ValueError, match="quant8"):
        serving.quantize_classifier(NoQuant())
    swin = SwinTransformer(patch_size=[2, 2], embed_dim=16, depths=[1],
                           num_heads=[2], window_size=[4, 4], num_classes=3,
                           image_size=8, device="cpu")
    with pytest.raises(ValueError, match="quant8"):
        serving.quantize_classifier(swin)


def test_quant8_keeps_the_fused_block_off_and_refuses_training(
        models, monkeypatch):
    _, _, model = models
    qmodel = serving.quantize_classifier(model)
    monkeypatch.setattr(vv, "USE_FUSED_BLOCK", True)
    x3 = torch.zeros(2, 17, 64)
    assert model.encoder.encoder_layer_0._use_fused_block(x3, False)
    assert not qmodel.encoder.encoder_layer_0._use_fused_block(x3, False)
    quant.reset_product_counts()
    with torch.no_grad():
        qmodel(torch.zeros(1, *SHAPE))
    assert quant.PRODUCTS["int8_matmul"] == 4 * CFG["num_layers"]
    with pytest.raises(ValueError, match="serving-only"):
        trainer.train_step_fn(qmodel)
    with pytest.raises(ValueError, match="serving-only"):
        qmodel.train_model(qmodel, [(np.zeros((1, *SHAPE)), [0])], [], 1,
                           verbose=False)
