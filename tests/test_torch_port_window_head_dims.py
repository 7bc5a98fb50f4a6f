"""The batched window forward (row 11) and its backward (row 10) at head dims
outside the pack and fused plans' (dh <= 64 dividing 128), against the JAX
package.

The JAX batched plan (``window_batched_plan``) has no head-dim term: it takes
any dh its VMEM budget admits, runs ``_window_batched_kernel`` forward and
differentiates ``_window_pack_ref`` with jnp at these dh. The port's CUDA
kernels take the same dh (csrc/window_mma_tile.cuh's padded tiles,
csrc/window_chunk_tile.cuh's chunks) and keep the JAX budget as the route
rule. On the CPU the port's wrappers run their plain versions, which must
compute the JAX package's function: inputs from a numpy seed feed both
packages, the Pallas forward runs in interpret mode (as the JAX package's
own tests run it), every JAX oracle is jitted. Tolerances are fp32:
|got − want| <= 1e-5 · max(1, max|want|) on attention outputs and
gradients (the two packages sum in different orders), 1e-4 on model
logits.

The kernels themselves are held against the plain versions in
tests/test_torch_port_kernels.py, on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_windows import _jax_tpu_route, _port_route
from vision_transformers_tpu.models.image_classification import (
    swin_transformer as jswin,
)
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformer,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import windows as twin
from vision_transformers_tpu_torch.utils.port_jax import (
    swin_state_dict_from_jax,
)

ATOL = 1e-5
MODEL_ATOL = 1e-4
# head dims of the 16 and 64 tiles and of the chunks (96 and 192)
OTHER_DIMS = [12, 48, 96, 192]


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, tol=ATOL):
    """|got - want| <= tol · max(1, max|want|), elementwise."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _case(g, n, heads, dh, seed):
    return (_randn(seed, g, n, 3 * heads * dh, scale=0.5),
            _randn(seed + 1, 1, heads, n, n, scale=0.5))


@functools.lru_cache(maxsize=None)
def _jax_forward(heads, scale, blk):
    return jax.jit(functools.partial(jfa._window_batched_fwd_pallas,
                                     heads=heads, scale=scale, blk=blk))


@pytest.mark.parametrize("dh", OTHER_DIMS)
def test_batched_forward_matches_the_pallas_kernel(dh):
    """Row 11's plain route against ``_window_batched_fwd_pallas`` in
    interpret mode (8 windows, one block), with the shared bias."""
    g, n, heads = 8, 16, 2
    qkv, bias = _case(g, n, heads, dh, 10 + dh)
    assert jfa.window_batched_plan(g, n, heads, dh, 1, 4) == 8
    assert tfa.window_batched_plan(g, n, heads, dh, 1, 4) is not None
    with jax.default_matmul_precision("highest"):
        want = _jax_forward(heads, dh ** -0.5, 8)(jnp.asarray(qkv),
                                                  jnp.asarray(bias))
    got = tfa.window_batched_attention(torch.from_numpy(qkv),
                                       torch.from_numpy(bias), heads)
    assert got.shape == (g, n, heads * dh)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_vjp(heads):
    def run(qkv, bias, do):
        _, vjp = jax.vjp(
            lambda a, b: jfa.window_batched_attention(a, b, heads), qkv, bias)
        return vjp(do)
    return jax.jit(run)


@pytest.mark.parametrize("dh", OTHER_DIMS)
def test_batched_gradient_matches_jax_vjp(dh):
    """``torch.autograd`` through the port (row 10's plain version) against
    ``jax.vjp`` of JAX's ``window_batched_attention``, whose backward at
    these dh is the jnp VJP of ``_window_pack_ref``: dqkv and dbias."""
    g, n, heads = 8, 16, 2
    qkv, bias = _case(g, n, heads, dh, 20 + dh)
    do = _randn(30 + dh, g, n, heads * dh)
    with jax.default_matmul_precision("highest"):
        want_q, want_b = _jax_vjp(heads)(jnp.asarray(qkv), jnp.asarray(bias),
                                         jnp.asarray(do))
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    tfa.window_batched_attention(tq, tb, heads).backward(torch.from_numpy(do))
    _close(tq.grad, want_q)
    _close(tb.grad, want_b)


# (N, H, dh) across the edge of the JAX budget: the largest dh it admits at
# H 1 and 4 (one shared bias) and one past it, in bf16 and fp32, and
# Swin widths at H·dh 2144 / 2176 (N 49, dh 32, bf16: 67 heads fit, 68 do
# not).
_EDGE = {
    2: [(49, 1, 1534), (49, 1, 1535), (64, 1, 1161), (64, 1, 1162),
        (128, 1, 532), (128, 1, 533), (16, 4, 1588), (16, 4, 1589),
        (49, 4, 510), (49, 4, 511), (64, 4, 385), (64, 4, 386),
        (128, 4, 176), (128, 4, 177), (49, 67, 32), (49, 68, 32)],
    4: [(49, 1, 919), (49, 1, 920), (64, 1, 696), (64, 1, 697),
        (128, 1, 318), (128, 1, 319), (16, 4, 840), (16, 4, 841),
        (49, 4, 269), (49, 4, 270), (64, 4, 203), (64, 4, 204),
        (128, 4, 92), (128, 4, 93), (49, 33, 32), (49, 34, 32)],
}


@pytest.mark.parametrize("itemsize", [2, 4])
def test_batched_plan_is_none_exactly_where_the_jax_plan_is(itemsize):
    """The port's ``window_batched_plan`` is None exactly where JAX's is at
    its least block (G a multiple of 32, so the JAX plan tries 32, 16, 8),
    over a grid of (N, H, dh) that crosses the budget's edge; the largest
    dh of ``_EDGE`` are admitted and one more refused."""
    grid = [(n, h, dh) for n in (16, 49, 64, 128) for h in (1, 3, 4, 24)
            for dh in (1, 12, 32, 48, 96, 192, 256, 318, 532, 919, 1534)]
    for n, h, dh in grid + _EDGE[itemsize]:
        want = jfa.window_batched_plan(32, n, h, dh, 1, itemsize) is None
        got = tfa.window_batched_plan(32, n, h, dh, 1, itemsize) is None
        assert got == want, (n, h, dh, itemsize)
    for k in range(0, len(_EDGE[itemsize]), 2):
        (n, h, dh), past = _EDGE[itemsize][k:k + 2]
        assert tfa.window_batched_plan(8, n, h, dh, 1, itemsize) is not None
        assert tfa.window_batched_plan(8, *past, 1, itemsize) is None
        assert tfa.window_bwd_plan(8, n, h, dh) is not None
    assert tfa.window_batched_plan(8, 129, 1, 32, 1, 2) is None


@pytest.mark.parametrize("dh", [12, 20, 24, 48, 96, 128, 192, 1534])
def test_batched_and_backward_route_every_admitted_head_dim(dh):
    """Rows 10 and 11 route every dh the batched plan admits: the padded
    tiles up to 64, the chunks above; the packed and fused kernels keep
    ``WINDOW_HEAD_DIMS``. A copy goes by the grain the head dim's offsets
    keep."""
    tile = next((t for t in (16, 32, 64) if dh <= t), 0)
    for n in (16, 49, 64, 100, 128):
        want = f"tensor_cores_tile{tile}" if tile else "tensor_cores_chunked"
        assert tfa.window_route(torch.bfloat16, n, dh, "batched") == want
        assert tfa.window_route(torch.bfloat16, n, dh, "bwd") == want
        for kernel in ("batched", "bwd"):
            assert tfa.window_route(torch.float32, n, dh, kernel) == \
                "cuda_cores_chunked"
        for kernel in ("packed", "fused_flat", "fused_slab"):
            with pytest.raises(ValueError, match="head dim"):
                tfa.window_route(torch.bfloat16, n, dh, kernel)
    grain = {12: 8, 20: 8, 24: 16, 48: 16, 96: 16, 128: 16, 192: 16,
             1534: 4}[dh]
    assert tfa.window_grain(dh, 2) == grain
    assert tfa.window_grain(dh, 2, 3 * dh) == grain
    assert tfa.window_grain(5, 2) == 2 and tfa.window_grain(6, 2) == 4


# Swin-T's published widths (arXiv:2103.14030: C 96, depths 2-2-6-2, window
# 7) at 2 and at 1 heads a stage: dh 48 and 96.
@pytest.mark.parametrize("heads", [[2, 4, 8, 16], [1, 2, 4, 8]])
def test_swin_t_at_fewer_heads_routes_as_the_jax_package(monkeypatch, heads):
    """At batch 32 every block takes the route the JAX package takes on a
    TPU, traced with shapes only: the unshifted blocks of stages 1 and 2
    and both of stage 4 (one window, no shift) the batched kernel, stage
    3's (4 windows, a count in [2, 8]) and every shifted block the
    split-head path (no pack or fused plan takes dh 48 or 96). So do 67 and
    68 heads at dh 32 (H·dh 2144, 2176), where the batched plan's budget
    admits and then refuses."""
    size, win = 56, (7, 7)
    routes = []
    for stage, (depth, h) in enumerate(zip((2, 2, 6, 2), heads)):
        c = 96 * 2 ** stage
        for layer in range(depth):
            shift = (0, 0) if layer % 2 == 0 else (3, 3)
            got = _port_route(monkeypatch, 32, size, c, h, win, shift, False)
            assert got == _jax_tpu_route(monkeypatch, 32, size, c, h, win,
                                         shift, False), (stage, layer)
            routes.append(got)
        size = -(-size // 2)
    assert routes == ["batched", "split"] * 2 + ["split"] * 6 \
        + ["batched", "batched"]
    for h, route in ((67, "batched"), (68, "pack")):
        args = (monkeypatch, 32, 7, 32 * h, h, win, (0, 0), False)
        assert _port_route(*args) == _jax_tpu_route(*args) == route


NARROW_SWIN48 = dict(patch_size=[2, 2], embed_dim=96, depths=[2, 2],
                     num_heads=[2, 4], window_size=[4, 4], num_classes=10,
                     stochastic_depth_prob=0.0)


def test_narrow_swin_at_dh48_matches_jax():
    """A narrow Swin at dh 48 (embed 96, 2 heads then 4, 2 stages, window 4
    at 36 px: 25 and then 9 windows, both outside [2, 8]): its logits
    against the JAX model's, the weights converted by
    ``swin_state_dict_from_jax``; the unshifted blocks take the batched
    kernel in both packages, the shifted ones the split-head path."""
    jmodel = jswin.SwinTransformer(**NARROW_SWIN48)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 36, 36, 3)))["params"]
    rng = np.random.RandomState(48)
    params = jax.tree.map(
        lambda a: (rng.randn(*a.shape) * (0.1 if len(a.shape) > 1 else 0.3)
                   + (len(a.shape) == 1)).astype(np.float32), shapes)
    x = _randn(49, 2, 36, 36, 3)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx))(
            params, jnp.asarray(x))
    tmodel = SwinTransformer(**NARROW_SWIN48, device="cpu")
    tmodel.load_state_dict(swin_state_dict_from_jax(params), strict=True)
    tmodel.eval()
    twin.ROUTE_LOG = []
    try:
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x))
        routes = list(twin.ROUTE_LOG)
    finally:
        twin.ROUTE_LOG = None
    assert routes == ["batched", "split", "batched", "split"]
    _close(got, want, MODEL_ATOL)
