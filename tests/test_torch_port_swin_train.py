"""Training the port's Swin and SwinV2 against the JAX package.

Same weights in both packages (JAX params perturbed from a numpy seed,
converted by ``swin_state_dict_from_jax``), same numpy batches, fp32 on the
CPU, where the window wrappers' autograd functions run the plain version of
the window backward kernel. JAX runs under the highest matmul precision.
Stochastic depth is 0 wherever the two packages are compared: their
drop-path masks come from different generators and cannot be matched, so
the port's ``DropPath`` is tested within the port (keep rate, seed replay).
Tolerance: 1e-4 on losses, gradients and parameters of O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import (
    swin_transformer as jswin,
)
from vision_transformers_tpu.training import optimizers as jopt
from vision_transformers_tpu.training import trainer as jtrainer
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformer,
    SwinTransformerV2,
)
from vision_transformers_tpu_torch.ops.layers import DropPath
from vision_transformers_tpu_torch.training import trainer as ttrainer
from vision_transformers_tpu_torch.utils.port_jax import swin_state_dict_from_jax

MODEL_ATOL = 1e-4


def _highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _close(got, want, atol=MODEL_ATOL):
    got = got.detach().float().numpy()
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


NARROW = dict(patch_size=[2, 2], embed_dim=16, depths=[2, 2],
              num_heads=[2, 4], window_size=[4, 4], num_classes=10,
              stochastic_depth_prob=0.0)
SHAPE = (20, 20, 3)
PAIRS = {"v1": (jswin.SwinTransformer, SwinTransformer),
         "v2": (jswin.SwinTransformerV2, SwinTransformerV2)}


def _perturbed_params(module, seed, *inputs):
    params = jax.device_get(
        module.init(jax.random.PRNGKey(seed), *inputs)["params"])
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), params)


def _batch(seed, n=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *SHAPE).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32), np.ones(n, np.float32))


@pytest.mark.parametrize("version", list(PAIRS))
def test_model_gradients_match_jax(version):
    """Loss gradients of a narrow 2-stage model for every parameter, in
    training mode with stochastic depth 0 (drop-path masks cannot be matched
    across packages)."""
    jcls, tcls = PAIRS[version]
    jmodel = jcls(**NARROW)
    params = _perturbed_params(jmodel, 0, jnp.zeros((1, *SHAPE)))
    x, y, w = _batch(90)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              deterministic=False)
        return jtrainer.cross_entropy_with_weights(
            logits, jnp.asarray(y), jnp.asarray(w))

    want_loss, want = _highest(jax.value_and_grad(loss), params)
    want = swin_state_dict_from_jax(jax.device_get(want))
    tmodel = tcls(**NARROW, device="cpu")
    tmodel.load_state_dict(swin_state_dict_from_jax(params), strict=True)
    tmodel.train()
    got_loss = ttrainer.cross_entropy_with_weights(
        tmodel(torch.from_numpy(x)), torch.from_numpy(y).long(),
        torch.from_numpy(w))
    got_loss.backward()
    assert abs(got_loss.item() - float(want_loss)) <= MODEL_ATOL
    names = dict(tmodel.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        _close(p.grad, want[name])
    table = ("stage0_block1.attn.relative_position_bias_table" if version == "v1"
             else "stage0_block1.attn.cpb_fc1.weight")
    assert float(names[table].grad.abs().max()) > 1e-6  # dbias arrives
    if version == "v2":
        assert float(names["stage1_block0.attn.logit_scale"].grad.abs().max()) \
            > 1e-6


def _zero_gradient_parameter(name):
    """The key third of ``qkv_bias`` has a true gradient of 0 (softmax
    cancels q·b_k); Adam turns each package's rounding noise of it into steps
    of size lr, so it is left out of the trajectory comparison. SwinV2 has no
    key bias."""
    return name.endswith("attn.qkv_bias")


@pytest.mark.parametrize("version", list(PAIRS))
def test_adam_trajectory_matches_jax(version):
    """6 Adam steps at lr 1e-3 through both packages' ``train_step_fn``:
    losses and final parameters."""
    jcls, tcls = PAIRS[version]
    jmodel = jcls(**NARROW)
    params = _perturbed_params(jmodel, 1, jnp.zeros((1, *SHAPE)))
    batches = [_batch(91 + i) for i in range(6)]

    jstate = jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=jopt.make_optimizer("adam", 1e-3))
    jstep = jax.jit(jtrainer.train_step_fn(jmodel))
    want_losses = []
    with jax.default_matmul_precision("highest"):
        for i, (x, y, w) in enumerate(batches):
            jstate, loss_n, _, n = jstep(jstate, x, y, w,
                                         jax.random.PRNGKey(i))
            want_losses.append(float(loss_n) / float(n))
    want = swin_state_dict_from_jax(jax.device_get(jstate.params))

    tmodel = tcls(**NARROW, device="cpu")
    tmodel.load_state_dict(swin_state_dict_from_jax(params), strict=True)
    tstate = ttrainer.make_train_state(tmodel, lr=1e-3)
    tstep = ttrainer.train_step_fn(tmodel)
    got_losses = []
    for x, y, w in batches:
        tstate, loss_n, _, n = tstep(tstate, x, y, w)
        got_losses.append((loss_n / n).item())
    np.testing.assert_allclose(got_losses, want_losses, atol=MODEL_ATOL,
                               rtol=0)
    moved = 0.0
    start = swin_state_dict_from_jax(params)
    for name, p in tmodel.named_parameters():
        if _zero_gradient_parameter(name):
            continue
        _close(p, want[name])
        moved = max(moved, float((p.detach() - start[name]).abs().max()))
    assert moved > 1e-3  # the comparison is not of two standstills


def test_drop_path_keep_rate_and_seed_replay():
    dp = DropPath(0.25)
    dp.train()
    x = torch.ones(4000, 3, 2)
    out = dp(x, seed=5)
    kept = out[:, 0, 0] != 0
    assert torch.equal(out, dp(x, seed=5))          # the seed is the mask
    assert not torch.equal(out, dp(x, seed=6))
    assert bool((out[kept] == 1 / 0.75).all())      # survivors rescaled
    assert bool((out[~kept] == 0).all())            # a sample drops whole
    rate = kept.float().mean().item()
    assert abs(rate - 0.75) <= 3 * (0.75 * 0.25 / 4000) ** 0.5
    with pytest.raises(ValueError, match="seed"):
        dp(x)
    dp.eval()
    assert dp(x) is x


@pytest.mark.parametrize("version", list(PAIRS))
def test_fit_with_stochastic_depth_is_reproducible_from_its_seed(version):
    """``train_model`` on a narrow model with stochastic depth on: the same
    seed gives the same history, another seed another, NCHW input is taken,
    and the model is left in eval mode."""
    _, tcls = PAIRS[version]
    cfg = dict(NARROW, stochastic_depth_prob=0.3)
    rng = np.random.RandomState(95)
    images = rng.randint(0, 255, (24, 3, 20, 20)).astype(np.uint8)  # NCHW
    labels = rng.randint(0, 10, 24).astype(np.int32)
    loader = [(images[i:i + 8], labels[i:i + 8]) for i in range(0, 24, 8)]

    def run(seed):
        model = tcls(**cfg, device="cpu")
        hist = model.train_model(model, loader, loader, 2, lr=1e-3,
                                 seed=seed, verbose=False)
        assert not model.training and hist["final_state"].step == 6
        return hist["train_loss"]

    first = run(1)
    assert np.isfinite(first).all() and first == run(1)
    assert first != run(2)
