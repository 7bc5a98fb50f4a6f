"""The port's single-pass Adam against the JAX package's.

Leaves and gradients come from a numpy seed and feed both packages. On the
CPU the port's large leaves take the kernel's plain version
(``fused_adam_reference``); the JAX ``fused_adam_update`` runs its Pallas
kernel in interpret mode for leaves of 65 536 elements or more and
``_jnp_leaf`` below that, as its own tests run it.

Tolerance: 1e-6 absolute on parameters of O(1) and moments of O(1) after a
few steps: both sides compute in fp32 in the same order (m·c1, not
m/(1 − b1ᵗ)), and differ by the rounding of the two bias-correction scalars
(numpy's against XLA's ``pow``) and by fused multiply-adds. Against the
port's unfused Adam, which mirrors optax and divides where the kernel
multiplies: 1e-6 relative to the largest parameter.

The CUDA kernel itself is held against the plain version in
``tests/test_torch_port_kernels.py``, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops import fused_adam as jadam
from vision_transformers_tpu.training import optimizers as jopt
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import fused_adam as tadam
from vision_transformers_tpu_torch.training import optimizers as topt

ATOL = 1e-6

# both sides of 65 536 elements: the first two take the kernel
SHAPES = [(300, 300), (512, 128), (255, 257), (40, 30), (10,), (1,)]


def _leaves(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_close(got, want, atol=ATOL):
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(r, np.float32), atol=atol,
                                   rtol=0)


def test_leaf_sizes_straddle_the_kernel_threshold():
    assert tadam._MIN_FUSED_SIZE == jadam._MIN_FUSED_SIZE == 65536
    sizes = [int(np.prod(s)) for s in SHAPES]
    assert sum(n >= 65536 for n in sizes) == 2 and sizes[1] == 65536
    assert sizes[2] == 65535


@pytest.mark.parametrize("n", [1, 3, 65535, 65536, 65539, 768 * 3072])
def test_every_fp32_leaf_on_cuda_joins_the_launch(n):
    """On CUDA every non-empty fp32 leaf takes the kernel, small ones too
    (one launch a step); on the CPU the JAX package's split by size stays;
    other dtypes take the plain version on both."""
    assert tadam.adam_route("cuda", torch.float32, n) == "kernel"
    assert tadam.adam_route("cpu", torch.float32, n) == (
        "reference" if n >= 65536 else "foreach")
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        for device in ("cuda", "cpu"):
            assert tadam.adam_route(device, dtype, n) == "reference"
    assert tadam.adam_route("cuda", torch.float32, 0) == "reference"


def test_cpu_leaves_keep_the_jax_split():
    """``FusedAdamLeaves`` on the CPU binds no card and sorts the leaves as
    the JAX package does: the two of 65 536 elements or more to the plain
    version, the small fp32 ones to the foreach path, a bf16 leaf to the
    plain version."""
    params = _t(_leaves(0)) + [torch.zeros(4, dtype=torch.bfloat16)]
    moments = [torch.zeros(p.shape) for p in params]
    leaves = tadam.FusedAdamLeaves(params, moments, list(moments))
    assert leaves.cards == []
    assert leaves.routes == {"foreach": [2, 3, 4, 5], "reference": [0, 1, 6]}


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_fused_adam_update_matches_jax(weight_decay):
    """4 steps of ``fused_adam_update`` with a learning rate that changes
    every step: parameters and both moments."""
    params, mu, nu = _leaves(0), _leaves(1, 0.0), _leaves(2, 0.0)
    tp, tm, tv = _t(params), _t(mu), _t(nu)
    jp, jm, jv = _j(params), _j(mu), _j(nu)
    ptrs = [t.data_ptr() for t in tp + tm + tv]
    tfa.reset_launch_counts()
    for step in range(1, 5):
        grads = _leaves(10 + step, 0.1)
        lr = 1e-2 / step
        out = tadam.fused_adam_update(tp, tm, tv, _t(grads), step, lr,
                                      weight_decay=weight_decay)
        assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
        jp, jm, jv = jadam.fused_adam_update(
            jp, jm, jv, _j(grads), step, lr, weight_decay=weight_decay)
    assert ptrs == [t.data_ptr() for t in tp + tm + tv]
    assert not any(tfa.LAUNCHES.values())  # CPU tensors never count
    _assert_close(tp, jp)
    _assert_close(tm, jm)
    _assert_close(tv, jv)
    moved = max(float(np.abs(a.numpy() - b).max())
                for a, b in zip(tp, params))
    assert moved > 1e-2  # the comparison is not of two standstills


def test_reference_is_the_small_leaf_arithmetic():
    """The kernel's plain version and the batched small-leaf path are one
    arithmetic: a leaf gives the same bits on either side of the threshold."""
    params, mu, nu = _leaves(3), _leaves(4, 0.1), _leaves(5, 0.0)
    nu = [np.abs(a) for a in _leaves(5, 0.1)]
    grads = _leaves(6, 0.1)
    s = tadam.adam_scalars(3, 1e-3, weight_decay=0.01)
    a = [_t(params), _t(mu), _t(nu)]
    b = [_t(params), _t(mu), _t(nu)]
    for leaf in zip(*a, _t(grads)):
        tadam.fused_adam_reference(*leaf, s)
    tadam._small_leaves(*b, _t(grads), s)
    for got, want in zip(a, b):
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_scalars_are_fp32_and_use_the_one_based_count():
    s = tadam.adam_scalars(1, 1e-3, weight_decay=0.1)
    f = np.float32
    assert s.b1 == float(f(0.9)) and s.neg_lr == -float(f(1e-3))
    assert s.c1 == float(f(1) / (f(1) - f(0.9)))
    assert s.c2 == float(f(1) / (f(1) - f(0.999)))
    assert all(float(f(x)) == x for x in s)  # every scalar is an fp32 value


def test_non_fp32_leaf_keeps_its_dtype():
    """``_jnp_leaf``: a bf16 parameter leaf stays bf16 (fp32 moments), with
    the update computed in fp32, in both packages."""
    rng = np.random.RandomState(7)
    p = rng.randn(64, 8).astype(np.float32)
    g = (0.1 * rng.randn(64, 8)).astype(np.float32)
    tp = [torch.tensor(p).bfloat16()]
    tm, tv = [torch.zeros(64, 8)], [torch.zeros(64, 8)]
    jp, jm, jv = jadam.fused_adam_update(
        [jnp.asarray(p, jnp.bfloat16)], [jnp.zeros((64, 8))],
        [jnp.zeros((64, 8))], [jnp.asarray(g, jnp.bfloat16)], 1, 1e-2)
    tadam.fused_adam_update(tp, tm, tv, [torch.tensor(g).bfloat16()], 1, 1e-2)
    assert tp[0].dtype == torch.bfloat16 and tm[0].dtype == torch.float32
    assert jp[0].dtype == jnp.bfloat16
    # one bf16 ulp of a parameter of magnitude <= 4
    _assert_close(tp, jp, atol=2.0 ** -6)
    _assert_close(tm, jm)
    _assert_close(tv, jv)


def _cosine(count):
    return 1e-2 * 0.5 * (1.0 + np.cos(np.pi * min(count, 8) / 8))


@pytest.mark.parametrize("name,weight_decay", [("adam", 0.0), ("adam", 0.02),
                                               ("adamw", 0.02)])
def test_fused_optimizer_matches_jax_fused_apply(name, weight_decay):
    """``make_optimizer(fused=True)`` in both packages, with a schedule (read
    at the pre-update count) and decoupled weight decay, 5 steps."""
    params = _leaves(20)
    tparams = [t.requires_grad_() for t in _t(params)]
    tx = topt.make_optimizer(name, schedule=_cosine,
                             weight_decay=weight_decay, fused=True)
    tx.init(tparams)
    jtx = jopt.make_optimizer(
        name, schedule=lambda c: 1e-2 * 0.5 * (
            1.0 + jnp.cos(jnp.pi * jnp.minimum(c, 8) / 8)),
        weight_decay=weight_decay, fused=True)
    jparams = _j(params)
    jstate = jtx.init(jparams)
    ptrs = [p.data_ptr() for p in tparams]
    for step in range(5):
        grads = _leaves(30 + step, 0.1)
        for p, g in zip(tparams, _t(grads)):
            p.grad = g
        assert tx.lr_at(tx.count) == pytest.approx(_cosine(step))
        tx.step()
        jparams, jstate = jtx.fused_apply(jparams, _j(grads), jstate)
    assert tx.count == 5 and int(jstate.count) == 5
    assert ptrs == [p.data_ptr() for p in tparams]  # the model's own tensors
    _assert_close(tparams, jparams)
    _assert_close(tx.state["mu"], jstate.mu)
    _assert_close(tx.state["nu"], jstate.nu)


@pytest.mark.parametrize("weight_decay", [0.0, 0.02])
def test_fused_optimizer_matches_the_unfused_one(weight_decay):
    """m·c1 against m/(1 − b1ᵗ): the last bit, 1e-6 relative after 6 steps."""
    runs = {}
    for fused in (True, False):
        params = [t.requires_grad_() for t in _t(_leaves(40))]
        tx = topt.make_optimizer("adam", 1e-3, weight_decay=weight_decay,
                                 fused=fused).init(params)
        for step in range(6):
            for p, g in zip(params, _t(_leaves(50 + step, 0.1))):
                p.grad = g
            tx.step()
            tx.zero_grad()
        runs[fused] = params
    scale = max(float(p.detach().abs().max()) for p in runs[False])
    _assert_close(runs[True], [p.detach().numpy() for p in runs[False]],
                  atol=ATOL * scale)


def test_fused_moments_are_fp32_whatever_the_parameters():
    p = torch.zeros(4, 4, dtype=torch.bfloat16, requires_grad=True)
    tx = topt.make_optimizer("adam", fused=True).init([p])
    assert tx.fused and tx.state["mu"][0].dtype == torch.float32
    assert tx.state["nu"][0].dtype == torch.float32
    p.grad = torch.ones_like(p)
    tx.step()
    assert p.dtype == torch.bfloat16 and float(p[0, 0]) < 0


@pytest.mark.parametrize("kw", [dict(grad_clip_norm=1.0),
                                dict(accumulate_steps=4)])
def test_fused_refuses_clipping_and_accumulation_as_jax_does(kw):
    for mod in (topt, jopt):
        with pytest.raises(ValueError, match="does not compose"):
            mod.make_optimizer("adam", fused=True, **kw)
        mod.make_optimizer("adam", fused=False, **kw)  # the default path
        mod.make_optimizer("sgd", fused=True, **kw)    # fused is adam's


def test_fit_takes_the_fused_optimizer():
    """``fit(..., fused=True)`` reaches ``make_optimizer`` and trains as the
    unfused default does."""
    from synthetic_data import SyntheticLoader
    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.training import trainer as ttrainer

    cfg = dict(image_size=16, patch_size=4, num_layers=2, num_heads=2,
               hidden_dim=32, mlp_dim=64, num_classes=4, device="cpu")
    data = SyntheticLoader(32, 8, 16, 4, seed=60)
    losses = {}
    for fused in (True, False):
        model = ViT(**cfg)
        hist = ttrainer.fit(model, data, data, 2, lr=1e-3, verbose=False,
                            fused=fused)
        assert hist["final_state"].optimizer.fused == fused
        losses[fused] = hist["train_loss"]
    assert losses[True][-1] < losses[True][0]
    np.testing.assert_allclose(losses[True], losses[False], atol=1e-5, rtol=0)
