"""The port's superleaf Adam (``training/superleaf.py``) against the JAX
package's and against the port's per-leaf fused Adam, on the CPU, fp32.

- The flatten round trip is exact and pads to whole 131 072-element blocks.
- One step against JAX ``superleaf_train_step_fn`` at dropout 0 on a ViT
  small enough for one pad block: the loss within 1e-5 relative; the flat
  mu, which holds (1 − b1)·g after one step, within 1e-5 · max(1, max|mu|)
  of each leaf (the two packages' fp32 products sum in different orders);
  the parameters within 1e-6 where |g| > 1e-4, where Adam's first step is
  lr·g/(|g| + eps) and rounding noise in g does not flip it (elements whose
  true gradient is 0, the key third of ``qkv.bias`` among them, have a
  gradient of rounding noise, whose sign each package draws its own way).
- Three steps at dropout 0.1 against ``make_optimizer(fused=True)`` from the
  same weights and dropout seeds: losses and parameters bit-equal (the same
  forward on views of the flat buffer, and the kernel's plain version on
  both sides).
- The refusal of non-fp32 leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu.training import superleaf as jsl
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.training import superleaf as sl
from vision_transformers_tpu_torch.training import trainer
from vision_transformers_tpu_torch.training.optimizers import make_optimizer
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

CFG = dict(image_size=16, patch_size=4, num_layers=1, num_heads=2,
           hidden_dim=32, mlp_dim=64, num_classes=4)
NORMALIZE = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))


def _batch(seed, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (n, 16, 16, 3)).astype(np.uint8),
            rng.randint(0, 4, n).astype(np.int32), np.ones(n, np.float32))


def _jax_params(seed):
    """numpy draws into the JAX ViT's parameter shapes (flax's op-by-op init
    is slow on the CPU): LayerNorm scales about 1, everything else
    N(0, 0.1), so the head is non-zero and every gradient flows."""
    model = JViT(**CFG)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))["params"]
    rng = np.random.RandomState(seed)
    return model, jax.tree_util.tree_map_with_path(
        lambda path, s: (1.0 + 0.1 * rng.randn(*s.shape)
                         if path[-1].key == "scale"
                         else 0.1 * rng.randn(*s.shape)).astype(np.float32),
        shapes)


def _port_model(params, **kw):
    model = ViT(**CFG, **kw, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params))
    return model


def test_flatten_round_trip_and_padding():
    _, params = _jax_params(0)
    model = _port_model(params)
    tree = dict(model.named_parameters())
    meta = sl.build_meta(tree)
    flat = sl.flatten_tree(tree, meta)
    assert flat.shape[0] == meta.total_padded == sl._PAD_MULTIPLE
    assert not flat[sum(meta.sizes):].any()
    back = sl.unflatten_tree(flat, meta)
    assert list(back) == list(tree)
    for name, p in tree.items():
        assert torch.equal(back[name], p), name
        assert back[name].data_ptr() >= flat.data_ptr()  # a view of flat


def test_one_step_matches_jax_superleaf_at_rate_0():
    lr = 1e-3
    x, y, w = _batch(1)
    jmodel, params = _jax_params(2)
    jstate, jmeta = jsl.init_state(jax.tree.map(jnp.asarray, params))
    assert jmeta.total_padded == jsl._PAD_MULTIPLE  # one pad block
    jstep = jax.jit(jsl.superleaf_train_step_fn(jmodel, jmeta, lr,
                                                normalize=NORMALIZE))
    jstate, jloss, jcorrect, jn = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(w), jax.random.PRNGKey(0))

    model = _port_model(params)
    state, meta = sl.init_state(dict(model.named_parameters()))
    step = sl.superleaf_train_step_fn(model, meta, lr, normalize=NORMALIZE)
    state, loss, correct, n = step(state, x, y, w)
    assert state.step == 1 and float(n) == float(jn) == 8
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(correct) == float(jcorrect)

    def port_tree(flat):  # a JAX flat buffer → the port's names and layout
        return vit_state_dict_from_jax(jax.device_get(
            jsl.unflatten_tree(flat, jmeta)))

    want_mu, want_p = port_tree(jstate.mu), port_tree(jstate.flat)
    got_mu = sl.unflatten_tree(state.mu, meta)
    got_p = sl.unflatten_tree(state.flat, meta)
    assert set(got_mu) == set(want_mu)
    for name in got_mu:
        mu, ref = got_mu[name].numpy(), want_mu[name].numpy()
        np.testing.assert_allclose(
            mu, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()),
            err_msg=name)
        live = np.abs(ref) > 0.1 * 1e-4  # mu = 0.1·g: |g| > 1e-4
        np.testing.assert_allclose(got_p[name].numpy()[live],
                                   want_p[name].numpy()[live], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert not state.flat[sum(meta.sizes):].any()


def test_steps_bit_equal_to_the_per_leaf_fused_adam_with_dropout():
    x, y, w = _batch(3)
    _, params = _jax_params(4)
    drop = dict(dropout=0.1, attention_dropout=0.1)
    a, b = _port_model(params, **drop), _port_model(params, **drop)
    state, meta = sl.init_state(dict(a.named_parameters()))
    step = sl.superleaf_train_step_fn(a, meta, 1e-3)
    ref = trainer.make_train_state(b, tx=make_optimizer("adam", 1e-3,
                                                        fused=True))
    ref_step = trainer.train_step_fn(b)
    a.dropout_generator.manual_seed(5)  # as fit(seed=5) seeds it
    b.dropout_generator.manual_seed(5)
    for _ in range(3):
        state, loss, _, _ = step(state, x, y, w)
        ref, ref_loss, _, _ = ref_step(ref, x, y, w)
        assert float(loss) == float(ref_loss)
    got = sl.unflatten_tree(state.flat, meta)
    for name, p in b.named_parameters():
        assert torch.equal(got[name], p), name
    with pytest.raises(ValueError, match="serving-only"):
        sl.superleaf_train_step_fn(ViT(**CFG, quant8=True, device="cpu"),
                                   meta, 1e-3)


def test_superleaf_requires_fp32():
    params = {"w": torch.zeros(3, 4), "b": torch.zeros(4, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="fp32"):
        sl.build_meta(params)
