"""Rows 1-7 at head dims other than 16, 32 and 64, against the JAX package.

The CUDA kernels of rows 1-7 take any head dim: up to 128 the next tile of
16, 32, 64 or 128 with the columns past D zero (this file), above 128 the
wide kernels (tests/test_torch_port_head_dims_wide.py). On the CPU the port's
wrappers run their plain versions, which must compute the JAX package's
function at those dims too: inputs from a numpy seed feed both packages, the
JAX Pallas functions run in interpret mode (as the JAX package's own tests
run them), every JAX oracle is jitted. Tolerances are fp32: 1e-5 absolute on
attention outputs of O(1) magnitude and on gradients, times max(1, max|ref|)
(the two packages sum in different orders; more terms at D 128).

ViT-H/14 (Dosovitskiy et al. 2020, Table 1: hidden 1280, 16 heads, dh 80)
is held here at its head dim in a narrow model (hidden 160, 2 heads); the
full model runs on the card in ``chip_smoke.py``.

The kernels themselves are held against the plain versions in
tests/test_torch_port_kernels.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu.ops import attention as jattn
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

ATOL = 1e-5


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


def _close(got, want, tol=ATOL):
    """|got - want| <= tol · max(1, max|want|), elementwise."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _leaf(a):
    return torch.from_numpy(a).requires_grad_()


@pytest.mark.parametrize("d", [0, 1, 7, 12, 16, 77, 80, 96, 127, 128, 129])
def test_rows_1_to_7_take_every_head_dim_up_to_128(d):
    """One rule for rows 1-7: every D >= 1 (above 128 the wide kernels;
    tests/test_torch_port_head_dims_wide.py). Rows 8-13 keep theirs: the
    fused block takes only its tiles' head dims, the window route those of
    the JAX window plans (dh <= 64 dividing 128)."""
    assert tfa.attention_head_dim_supported(d) == (d >= 1)
    assert tfa.ATTENTION_HEAD_DIM_RULE == "D >= 1"
    if d == 0:  # no head dim at all: refused on every device
        z = torch.zeros(1, 1, 4, 0)
        with pytest.raises(ValueError, match="D >= 1"):
            tfa.flash_attention_fwd(z, z, z)
        with pytest.raises(ValueError, match="D >= 1"):
            tfa.packed_flash_attention_fwd(torch.zeros(1, 4, 0), 2)
    assert tfa.fused_block_supported(2 * d, 2) == (d in tfa.TILE_HEAD_DIMS)
    if d in tfa.WINDOW_HEAD_DIMS:
        assert tfa.window_route(torch.bfloat16, 49, d) == "tensor_cores"
    else:
        with pytest.raises(ValueError, match="head dim"):
            tfa.window_route(torch.bfloat16, 49, d)


@pytest.mark.parametrize("image,row", [(224, "packed"), (336, "split"),
                                       (518, "large")])
def test_vit_h14_routes_as_the_jax_package(image, row):
    """ViT-H/14 (16 heads of 80) at batch 4: both packages send 224 px
    (S 257) to the packed kernel (row 1), 336 px (S 577; 384 px is no
    multiple of the patch) to the split-head one (row 2) and 518 px (S 1370)
    to the streaming one (row 3), by the same budgets; in bf16 and fp32."""
    s = (image // 14) ** 2 + 1
    for itemsize in (2, 4):
        packed = tfa.packed_flash_supported(4, s, 3 * 1280, itemsize)
        assert packed == jfa.packed_flash_supported(4, s, 3 * 1280, itemsize)
        assert packed == (row == "packed")
    large = s * s > tfa.MAX_SCORE_ELEMS
    assert tfa.MAX_SCORE_ELEMS == jfa._SMALL_S_LIMIT
    assert large == (row == "large")


@pytest.mark.parametrize("dh", [12, 80, 128])
def test_packed_forward_and_gradient_match_jax(dh):
    """Rows 1 and 7's plain versions against ``packed_flash_attention``
    (``_packed_fwd_kernel`` and ``_packed_bwd_kernel`` in interpret mode):
    out, lse, and dqkv by ``jax.vjp``, with trailing keys masked."""
    b, s, heads, kv_valid = 2, 13, 2, 11
    qkv = _randn(dh, b, s, 3 * heads * dh)
    do = _randn(dh + 1, b, s, heads * dh)

    def jfwd(x, g):
        out, vjp = jax.vjp(
            lambda y: jfa.packed_flash_attention(y, heads,
                                                 kv_valid=kv_valid), x)
        _, lse = jfa._packed_fwd(x, heads, dh ** -0.5, kv_valid=kv_valid)
        return out, lse, vjp(g)[0]

    want_out, want_lse, want_grad = jax.jit(jfwd)(jnp.asarray(qkv),
                                                  jnp.asarray(do))
    x = _leaf(qkv)
    out = tfa.packed_flash_attention(x, heads, kv_valid=kv_valid)
    out.backward(torch.from_numpy(do))
    _, lse = tfa.packed_flash_attention_fwd(torch.from_numpy(qkv), heads,
                                            kv_valid=kv_valid)
    assert out.shape == (b, s, heads * dh) and lse.shape == (b, s, heads)
    _close(out, want_out)
    _close(lse, want_lse)
    _close(x.grad, want_grad)


@pytest.mark.parametrize("route", ["small", "large"])
def test_split_head_forward_at_d80_matches_jax(route, monkeypatch):
    """``flash_attention`` at D 80 through both of its forward routes: the
    small-S one (row 2's plain version against ``_attn_kernel`` in
    interpret mode, out and lse), and the streaming one past
    ``MAX_SCORE_ELEMS`` (row 3's plain version) at Sq 8 × Sk 190 000 against
    ``mha_reference`` jitted, with trailing keys masked (a streaming grid
    over a key axis this long would cost the interpreter minutes)."""
    d = 80
    taken = []
    real = tfa.flash_attention_large_fwd
    monkeypatch.setattr(tfa, "flash_attention_large_fwd",
                        lambda *a, **kw: taken.append(1) or real(*a, **kw))
    if route == "small":
        b, h, sq, sk, kv_valid = 2, 2, 24, 20, 17
    else:
        b, h, sq, sk, kv_valid = 1, 1, 8, 190_000, 189_000
    assert (sq * sk > tfa.MAX_SCORE_ELEMS) == (route == "large")
    q, k, v = (_randn(s_, b, h, n, d) for s_, n in ((40, sq), (41, sk),
                                                    (42, sk)))
    got, lse = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                       kv_valid=kv_valid)
    assert taken == ([1] if route == "large" else [])
    if route == "small":
        g = b * h
        want, want_lse = jax.jit(
            lambda *a: jfa._flash_fwd(*a, None, None, d ** -0.5, kv_valid,
                                      256))(
            *(jnp.asarray(x.reshape(g, -1, d)) for x in (q, k, v)))
        _close(_np(got).reshape(g, sq, d), want)
        _close(_np(lse).reshape(g, sq), _np(want_lse)[..., 0])
        _close(got, jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                        kv_valid=kv_valid))
    else:
        keep = jnp.arange(sk) < kv_valid
        want = jax.jit(lambda *a: jattn.mha_reference(
            *a, mask=keep[None, None, None, :]))(*map(jnp.asarray, (q, k, v)))
        _close(got, want)


@pytest.mark.parametrize("route", ["row 4", "row 6"])
@pytest.mark.parametrize("d", [80, 128])
def test_bias_free_backward_matches_jax(route, d, monkeypatch):
    """The bias-free backward of ``flash_attention`` at D 80 and 128 by both
    of its kernels: row 4 (``USE_PALLAS_BWD``, the small-S kernel) against
    ``_flash_bwd_pallas`` in interpret mode, row 6 (the default) against
    ``jax.vjp`` of ``flash_dropout_attention`` at rate 0
    (``_drop_bwd_kernel`` in interpret mode); kv_valid < Sk."""
    monkeypatch.setattr(tfa, "USE_PALLAS_BWD", route == "row 4")
    b, h, sq, sk, kv_valid = 1, 2, 19, 15, 13
    q, k, v = _randn(50, b, h, sq, d), _randn(51, b, h, sk, d), \
        _randn(52, b, h, sk, d)
    do = _randn(53, b, h, sq, d)
    leaves = [_leaf(a) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, kv_valid=kv_valid)
    out.backward(torch.from_numpy(do))
    if route == "row 4":
        _, lse = tfa.flash_attention_fwd(
            *map(torch.from_numpy, (q, k, v)), kv_valid=kv_valid)
        g = b * h
        flat = lambda x, s: jnp.asarray(_np(x).reshape(g, s, d))  # noqa: E731
        want = jax.jit(lambda *a: jfa._flash_bwd_pallas(
            *a, d ** -0.5, kv_valid))(
            flat(q, sq), flat(k, sk), flat(v, sk), flat(out, sq),
            jnp.asarray(_np(lse).reshape(g, sq, 1)), flat(do, sq))
        want = [_np(w).reshape(b, h, -1, d) for w in want]
    else:
        def jvjp(q_, k_, v_, do_):
            _, vjp = jax.vjp(lambda *a: jfa.flash_dropout_attention(
                *a, dropout_rate=0.0, seed=jnp.zeros((1,), jnp.int32),
                kv_valid=kv_valid), q_, k_, v_)
            return vjp(do_)
        want = jax.jit(jvjp)(*map(jnp.asarray, (q, k, v, do)))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


def test_narrow_vit_at_dh80_matches_jax():
    """A narrow ViT at ViT-H/14's head dim (hidden 160, 2 heads of 80, MLP
    320, 2 layers, patch 14 at 28 px), the JAX params converted by
    ``vit_state_dict_from_jax``: logits (1e-4) and every parameter's
    gradient of a weighted sum of the logits (1e-5 × max(1, max|ref|))."""
    kw = dict(image_size=28, patch_size=14, num_layers=2, num_heads=2,
              hidden_dim=160, mlp_dim=320, num_classes=10)
    jmodel = JViT(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 28, 28, 3)))["params"]
    rng = np.random.RandomState(7)
    params = jax.tree.map(
        lambda s: (rng.randn(*s.shape) * (0.05 if len(s.shape) > 1 else 0.3)
                   ).astype(np.float32), shapes)
    x = _randn(8, 3, 28, 28, 3)
    w = _randn(9, 3, 10)

    def loss(p, x_):
        logits = jmodel.apply({"params": p}, x_)
        return jnp.sum(logits * jnp.asarray(w)), logits

    (_, want_logits), want_grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tmodel = ViT(**kw, device="cpu")
    tmodel.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    logits = tmodel(torch.from_numpy(x))
    (logits * torch.from_numpy(w)).sum().backward()
    assert np.abs(_np(want_logits)).max() > 0.1
    np.testing.assert_allclose(_np(logits), _np(want_logits), atol=1e-4,
                               rtol=0)
    want = vit_state_dict_from_jax(jax.device_get(want_grads))
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad, want[name])
