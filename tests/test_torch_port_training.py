"""The PyTorch port's optimizers and trainer against the JAX package.

The same numpy-seeded parameters, gradients and batches go through both
packages on the CPU, in fp32:

- every optimizer of ``make_optimizer`` and ``cosine_schedule`` against
  optax over 6 steps, 1e-6 absolute on parameters of magnitude below 1;
- an 8-step Adam trajectory of ``train_step_fn`` against the JAX package's
  ``train_step_fn`` at dropout 0 (where the two packages' random streams do
  not matter): per-step losses and final parameters, 1e-4;
- ``fit``: ragged batches, NCHW input, ``steps_per_call``, one-shot loaders,
  seeding, the history dict, and what it still refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthetic_data import SyntheticLoader
from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu.training import optimizers as jopt
from vision_transformers_tpu.training import trainer as jtrainer
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.training import optimizers as topt
from vision_transformers_tpu_torch.training import trainer as ttrainer
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

TINY = dict(image_size=16, patch_size=4, num_layers=2, num_heads=4,
            hidden_dim=64, mlp_dim=128, num_classes=10)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (c) optimizers against optax

_SHAPES = {"w": (5, 7), "b": (7,), "s": (3, 2, 4)}

_OPT_CASES = {
    "adam": dict(name="adam"),
    "adam_weight_decay": dict(name="adam", weight_decay=0.05),
    "adamw": dict(name="adamw", weight_decay=0.01),
    "sgd_momentum": dict(name="sgd"),
    "sgd_no_momentum": dict(name="sgd", momentum=0.0),
    "rmsprop": dict(name="rmsprop"),
    "rmsprop_momentum_0.5": dict(name="rmsprop", momentum=0.5),
    "adam_clip": dict(name="adam", grad_clip_norm=0.5),
    "sgd_clip_inactive": dict(name="sgd", grad_clip_norm=1e3),
    "adam_accumulate_2": dict(name="adam", accumulate_steps=2),
    "sgd_clip_accumulate_3": dict(name="sgd", grad_clip_norm=1.0,
                                  accumulate_steps=3),
    "adamw_cosine": dict(name="adamw", weight_decay=0.01, cosine=(6, 2)),
    "adam_cosine_accumulate_2": dict(name="adam", accumulate_steps=2,
                                     cosine=(4, 1)),
}


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = dict(_OPT_CASES[case])
    name = kw.pop("name")
    cosine = kw.pop("cosine", None)
    lr, steps = 0.05, 6
    jkw, tkw = dict(kw), dict(kw)
    if cosine is not None:
        jkw["schedule"] = jopt.cosine_schedule(lr, *cosine)
        tkw["schedule"] = topt.cosine_schedule(lr, *cosine)
    params0 = {k: 0.3 * _randn(i, *s)
               for i, (k, s) in enumerate(_SHAPES.items())}
    grads = [{k: _randn(100 + 10 * t + i, *s) * (1 + t)
              for i, (k, s) in enumerate(_SHAPES.items())}
             for t in range(steps)]

    tx = jopt.make_optimizer(name, lr, **jkw)
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params0.items()}
    opt = topt.make_optimizer(name, lr, **tkw).init(tparams.values())

    for g in grads:
        updates, jstate = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in params0:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]),
                atol=1e-6, rtol=0, err_msg=f"{case}: {k}")
    k_acc = kw.get("accumulate_steps", 1)
    assert opt.count == steps // k_acc
    moved = max(np.abs(np.asarray(jparams[k]) - params0[k]).max()
                for k in params0)
    assert moved > 1e-3  # the comparison is not of two standstills


@pytest.mark.parametrize("total,warmup", [(10, 0), (10, 3), (2, 5), (1, 1),
                                          (100, 10)])
def test_cosine_schedule_matches_optax(total, warmup):
    want = jopt.cosine_schedule(0.3, total, warmup)
    got = topt.cosine_schedule(0.3, total, warmup)
    for count in range(max(total, warmup + 1) + 3):
        assert got(count) == pytest.approx(float(want(count)), abs=1e-7), count


def test_make_optimizer_rejects_what_it_cannot_do():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.make_optimizer("lion")
    with pytest.raises(NotImplementedError, match="row 15"):
        topt.make_optimizer("adam", fused=True)
    with pytest.raises(RuntimeError, match="init"):
        topt.make_optimizer("adam").step()
    with pytest.raises(ValueError, match="decay"):
        topt.cosine_schedule(0.1, 1, 0)


# ---------------------------------------------------------------------------
# Loss and preprocessing against the JAX package


def test_cross_entropy_with_weights_matches_jax():
    logits = _randn(0, 6, 10) * 3
    labels = np.array([1, 0, 9, 3, 3, 7])
    for weights in ([1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0], [0] * 6):
        w = np.asarray(weights, np.float32)
        want = jtrainer.cross_entropy_with_weights(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
        got = ttrainer.cross_entropy_with_weights(
            torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(w))
        assert float(got) == pytest.approx(float(want), abs=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("normalize", [None, ((0.5, 0.4, 0.3),
                                              (0.25, 0.2, 0.3))])
def test_default_preprocess_matches_jax(dtype, normalize):
    x = np.random.RandomState(1).randint(0, 255, (2, 4, 4, 3)).astype(dtype)
    want = jtrainer._default_preprocess(jnp.asarray(x), normalize)
    got = ttrainer._default_preprocess(torch.from_numpy(x), normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# (d) an 8-step Adam trajectory against the JAX train step


def _jax_params(seed):
    model = JViT(**TINY)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))["params"])
    rng = np.random.RandomState(seed)  # a nonzero head, so gradients flow
    params["head"]["kernel"] = rng.randn(64, 10).astype(np.float32) * 0.2
    params["head"]["bias"] = rng.randn(10).astype(np.float32) * 0.1
    return model, params


def test_adam_trajectory_matches_jax_train_step():
    n_steps, batch, lr = 8, 8, 1e-2
    normalize = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
    rng = np.random.RandomState(3)
    xs = rng.randint(0, 255, (n_steps, batch, 16, 16, 3)).astype(np.uint8)
    ys = rng.randint(0, 10, (n_steps, batch)).astype(np.int32)
    ws = np.ones((n_steps, batch), np.float32)
    ws[-1, -3:] = 0.0  # a padded (ragged) last batch

    jmodel, params = _jax_params(0)
    jstate = jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
        tx=jopt.make_optimizer("adam", lr))
    jstep = jax.jit(jtrainer.train_step_fn(jmodel, normalize))
    key = jax.random.PRNGKey(0)
    want = []
    for x, y, w in zip(xs, ys, ws):
        jstate, loss_n, correct, n = jstep(jstate, jnp.asarray(x),
                                           jnp.asarray(y), jnp.asarray(w), key)
        want.append((float(loss_n / n), float(correct), float(n)))

    model = ViT(**TINY, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params))
    state = ttrainer.make_train_state(model, lr=lr)
    step = ttrainer.train_step_fn(model, normalize)
    got = []
    for x, y, w in zip(xs, ys, ws):
        state, loss_n, correct, n = step(state, x, y, w)
        got.append((float(loss_n / n), float(correct), float(n)))

    assert state.step == n_steps and state.optimizer.count == n_steps
    np.testing.assert_allclose([g[0] for g in got], [w_[0] for w_ in want],
                               atol=1e-4, rtol=0)
    assert [g[1:] for g in got] == [w_[1:] for w_ in want]
    assert want[0][0] - want[-1][0] > 0.05  # the trajectory moved
    final = vit_state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.state_dict().items():
        got_p, want_p = p.numpy(), final[name].numpy()
        if name.endswith("self_attention.qkv.bias"):
            # The key bias adds the same q·b to every score of a row, which
            # softmax cancels: its true gradient is 0, each package computes
            # its own rounding noise of it, and Adam scales that noise to
            # steps of size lr. Compare the q and v thirds only.
            third = got_p.shape[0] // 3
            keep = np.r_[0:third, 2 * third:3 * third]
            got_p, want_p = got_p[keep], want_p[keep]
        np.testing.assert_allclose(got_p, want_p, atol=1e-4, rtol=0,
                                   err_msg=name)


def test_eval_step_matches_jax():
    jmodel, params = _jax_params(1)
    x = np.random.RandomState(4).randint(0, 255, (6, 16, 16, 3)).astype(np.uint8)
    y = np.array([1, 2, 3, 4, 5, 6], np.int32)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32)
    want = jtrainer.eval_step_fn(jmodel)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(w))
    model = ViT(**TINY, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params))
    got = ttrainer.eval_step_fn(model)(model, x, y, w)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(v) for v in want], atol=1e-4)


# ---------------------------------------------------------------------------
# (e) fit

_FIT_CFG = dict(image_size=16, patch_size=4, num_layers=2, num_heads=2,
                hidden_dim=32, mlp_dim=64, num_classes=4, device="cpu")
_KEYS = {f"{split}_{m}" for split in ("train", "val", "test")
         for m in ("loss", "accuracy")}


def _metrics(history):
    return {k: history[k] for k in _KEYS}


def test_fit_history_and_learning():
    model = ViT(**_FIT_CFG, dropout=0.1, attention_dropout=0.1)
    train = SyntheticLoader(64, 16, 16, 4, seed=0)
    test = SyntheticLoader(16, 8, 16, 4, seed=1)
    val = SyntheticLoader(16, 8, 16, 4, seed=2)
    history = model.train_model(model, train, test, 4, val, lr=3e-3,
                                verbose=False)
    assert _KEYS <= set(history)
    for k in _KEYS:
        assert len(history[k]) == 4 and np.isfinite(history[k]).all()
    assert history["train_loss"][-1] < history["train_loss"][0]
    state = history["final_state"]
    assert state.model is model and state.step == 16
    assert state.optimizer.count == 16
    assert not model.training  # left in eval mode, as it was built
    no_val = model.train_model(model, train, test, 1, verbose=False)
    assert no_val["val_loss"] is None and no_val["val_accuracy"] is None


def test_fit_ragged_batch_counts_every_example_once():
    model = ViT(**_FIT_CFG)
    train = SyntheticLoader(20, 8, 16, 2, seed=4)  # batches: 8, 8, 4
    test = SyntheticLoader(12, 8, 16, 2, seed=5)   # batches: 8, 4
    history = ttrainer.fit(model, train, test, 1, lr=0.0, verbose=False)
    # lr 0: the model stays at init, whose zero head gives logits 0:
    # loss ln(4) on every example, padding rows not counted
    assert history["train_loss"][0] == pytest.approx(np.log(4), abs=1e-5)
    assert history["test_loss"][0] == pytest.approx(np.log(4), abs=1e-5)
    assert history["test_accuracy"][0] == pytest.approx(
        float((test.labels == 0).mean()), abs=1e-6)


def test_fit_takes_nchw_float_input():
    nhwc = SyntheticLoader(16, 8, 16, 2, seed=6, dtype=np.float32)

    class NCHW:
        def __iter__(self):
            for images, labels in nhwc:
                yield torch.from_numpy(images.transpose(0, 3, 1, 2) / 255.0), \
                    torch.from_numpy(labels)

    class NHWC:
        def __iter__(self):
            for images, labels in nhwc:
                yield images / 255.0, labels

    runs = [ttrainer.fit(ViT(**_FIT_CFG), loader, loader, 2, lr=1e-3,
                         verbose=False) for loader in (NCHW(), NHWC())]
    assert _metrics(runs[0]) == _metrics(runs[1])


def test_fit_steps_per_call_2_equals_1():
    train = SyntheticLoader(40, 8, 16, 3, seed=8)  # 5 batches: chunks 2, 2, 1
    test = SyntheticLoader(24, 8, 16, 3, seed=9)
    runs = []
    for k in (1, 2):
        model = ViT(**_FIT_CFG, dropout=0.1, attention_dropout=0.1)
        runs.append(ttrainer.fit(model, train, test, 2, lr=1e-3, seed=7,
                                 verbose=False, steps_per_call=k))
        assert runs[-1]["final_state"].step == 10  # fillers are skipped
    for key in _KEYS - {"val_loss", "val_accuracy"}:
        np.testing.assert_allclose(runs[0][key], runs[1][key], atol=1e-6)


def test_fit_one_shot_generator_raises_on_epoch_2():
    data = SyntheticLoader(16, 8, 16, 2, seed=10)
    test = SyntheticLoader(8, 8, 16, 2, seed=11)
    history = ttrainer.fit(ViT(**_FIT_CFG), iter(data), test, 1,
                           verbose=False)
    assert history["final_state"].step == 2  # the probed batch is replayed
    with pytest.raises(RuntimeError, match="one-shot"):
        ttrainer.fit(ViT(**_FIT_CFG), iter(data), test, 2, verbose=False)


def test_fit_same_seed_same_history():
    train = SyntheticLoader(32, 8, 16, 4, seed=12)
    test = SyntheticLoader(8, 8, 16, 4, seed=13)

    def run(seed):
        model = ViT(**_FIT_CFG, dropout=0.2, attention_dropout=0.2)
        return _metrics(ttrainer.fit(model, train, test, 2, lr=1e-3,
                                     seed=seed, verbose=False))

    assert run(1) == run(1)
    assert run(1)["train_loss"] != run(2)["train_loss"]  # dropout is on


def test_fit_refuses_what_is_not_ported():
    model = ViT(**_FIT_CFG)
    data = SyntheticLoader(8, 8, 16, 2, seed=14)
    for kw, item in ((dict(mesh=object()), "item 10"),
                     (dict(checkpoint_dir="ckpt"), "item 5"),
                     (dict(teacher_fn=lambda x: x), "item 5")):
        with pytest.raises(NotImplementedError, match=item):
            ttrainer.fit(model, data, data, 1, verbose=False, **kw)


def test_multi_step_skips_all_padding_batches():
    model = ViT(**_FIT_CFG)
    state = ttrainer.make_train_state(model, lr=1e-3)
    x = np.zeros((3, 4, 16, 16, 3), np.uint8)
    y = np.zeros((3, 4), np.int32)
    w = np.array([[1, 1, 1, 1], [0, 0, 0, 0], [1, 1, 0, 0]], np.float32)
    state, loss_n, correct, n = ttrainer.multi_train_step_fn(model)(
        state, x, y, w)
    assert state.step == 2 and float(n) == 6.0
    loss_n, correct, n = ttrainer.multi_eval_step_fn(model)(model, x, y, w)
    assert float(n) == 6.0 and np.isfinite(float(loss_n))


# ---------------------------------------------------------------------------
# (f) the no-JAX import proof reaches the new modules


def test_import_proof_covers_the_training_modules():
    import test_torch_port_serving as proof

    mods = set(proof._port_modules())
    assert {"vision_transformers_tpu_torch.training.trainer",
            "vision_transformers_tpu_torch.training.optimizers",
            "vision_transformers_tpu_torch.models.image_classification.base",
            } <= mods
