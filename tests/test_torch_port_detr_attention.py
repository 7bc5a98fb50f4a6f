"""The port's masked streaming forward (row 3) and small-S backward (row 4)
against the JAX package, on the CPU.

Inputs come from a numpy seed and feed both packages. The port's wrappers
run their plain PyTorch versions on CPU tensors (the CUDA kernels are held
against those in tests/test_torch_port_kernels.py, on the card); the JAX
Pallas functions run in interpret mode. fp32, 1e-5 absolute on outputs, lse
and gradients (the packages sum in different orders).

- Row 3: the port's ``flash_attention(kv_mask=...)`` against the JAX
  ``flash_attention(kv_mask=...)``, which takes ``_flash_fwd_large``; the
  bias-free large-S route at tiny sizes with both packages' thresholds
  lowered by monkeypatch; a fully masked image against ``mha_reference``
  (the TPU kernel's zero-padded block keys make it differ there, on
  purpose).
- Row 4: the port's plain version against ``_flash_bwd_pallas``, called
  directly; the ``USE_PALLAS_BWD`` route's gradients.
- Masked gradients against ``jax.grad`` through the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops import attention as jattn
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.ops import attention as tattn
from vision_transformers_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


def _keep(b, sk, seed=3, kv_valid=None):
    m = np.random.RandomState(seed).rand(b, sk) > 0.35
    m[:, 0] = True  # every image has an unpadded pixel, as in DETR
    return m


def _qkv(b, h, sq, sk, d, seed=0):
    return (_randn(seed, b, h, sq, d), _randn(seed + 1, b, h, sk, d),
            _randn(seed + 2, b, h, sk, d))


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("b,h,sq,sk,d,kv_valid", [
    (2, 2, 40, 40, 8, None),    # self attention, S not a multiple of 128
    (2, 2, 24, 70, 16, 60),     # Sq != Sk (cross attention), kv_valid < Sk
    (1, 3, 33, 130, 8, None),   # keys over one 128-block
    (2, 1, 9, 200, 32, 150),
])
def test_masked_forward_matches_jax_large_kernel(b, h, sq, sk, d, kv_valid):
    q, k, v = _qkv(b, h, sq, sk, d)
    keep = _keep(b, sk)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_mask=jnp.asarray(keep), kv_valid=kv_valid)
    g = b * h
    _, want_lse = jfa._flash_fwd_large(
        jnp.asarray(q.reshape(g, sq, d)), jnp.asarray(k.reshape(g, sk, d)),
        jnp.asarray(v.reshape(g, sk, d)), d ** -0.5,
        sk if kv_valid is None else kv_valid, kv_mask=jnp.asarray(keep),
        heads=h)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(keep),
                              kv_valid=kv_valid)
    _, got_lse = tfa.flash_attention_fwd(tq, tk, tv,
                                         kv_mask=torch.from_numpy(keep),
                                         kv_valid=kv_valid)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(got_lse).reshape(g, sq),
                               _np(want_lse).reshape(g, sq), atol=ATOL,
                               rtol=0)


def test_bias_free_large_s_route_matches_jax(monkeypatch):
    """Above the score threshold a bias-free call takes the streaming kernel
    in both packages; both thresholds are lowered so that a tiny shape
    crosses it."""
    monkeypatch.setattr(jfa, "_SMALL_S_LIMIT", 500)
    monkeypatch.setattr(tfa, "MAX_SCORE_ELEMS", 500)
    calls = []
    real = tfa.flash_attention_large_fwd
    monkeypatch.setattr(tfa, "flash_attention_large_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = _qkv(2, 2, 30, 36, 16, seed=4)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_valid=31)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              kv_valid=31)
    assert calls == [1]
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            torch.zeros(1, 2, 30, 36))


def test_fully_masked_image_is_uniform_unlike_the_tpu_kernel():
    """An image whose keys are all masked averages its Sk values (what
    ``mha_reference`` gives). The Pallas kernel counts its zero-padded block
    keys too and gives Σv / Sk_padded: 200 / 256 of it here."""
    b, h, s, d = 2, 2, 200, 8
    q, k, v = _qkv(b, h, s, s, d, seed=7)
    keep = _keep(b, s)
    keep[1] = False
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(keep))
    want = tattn.mha_reference(tq, tk, tv,
                               mask=torch.from_numpy(keep)[:, None, None, :])
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(got[1]), np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), (h, s, d)), atol=ATOL, rtol=0)
    tpu = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_mask=jnp.asarray(keep))
    np.testing.assert_allclose(_np(tpu[0]), _np(got[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tpu[1]), _np(got[1]) * 200 / 256,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,sq,sk,d,kv_valid", [
    (2, 2, 20, 20, 8, None),
    (1, 3, 33, 17, 16, None),   # Sq != Sk
    (2, 2, 40, 40, 8, 29),      # kv_valid < Sk
    (1, 2, 100, 100, 32, None),  # the DETR decoder's self attention, narrow
])
def test_small_s_backward_matches_jax_pallas(b, h, sq, sk, d, kv_valid):
    q, k, v = _qkv(b, h, sq, sk, d, seed=10)
    do = _randn(13, b, h, sq, d)
    kvv = sk if kv_valid is None else kv_valid
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, kv_valid=kv_valid)
    g = b * h
    flat = lambda x, s: jnp.asarray(_np(x).reshape(g, s, d))  # noqa: E731
    want = jfa._flash_bwd_pallas(
        flat(q, sq), flat(k, sk), flat(v, sk), flat(out, sq),
        jnp.asarray(_np(lse).reshape(g, sq, 1)), flat(do, sq), d ** -0.5, kvv)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo,
                                  kv_valid=kv_valid)
    for a, w, s in zip(got, want, (sq, sk, sk)):
        np.testing.assert_allclose(_np(a).reshape(g, s, d), _np(w),
                                   atol=ATOL, rtol=0)


def _grads_both(q, k, v, do, keep, kv_valid):
    def jloss(q_, k_, v_):
        out = jfa.flash_attention(
            q_, k_, v_, kv_mask=None if keep is None else jnp.asarray(keep),
            kv_valid=kv_valid)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(
        *leaves, kv_mask=None if keep is None else torch.from_numpy(keep),
        kv_valid=kv_valid)
    out.backward(torch.from_numpy(do))
    return [t.grad for t in leaves], want


@pytest.mark.parametrize("b,h,sq,sk,d,kv_valid", [
    (2, 2, 30, 30, 8, None),
    (2, 2, 16, 45, 16, 40),
])
def test_masked_gradients_match_jax_grad(b, h, sq, sk, d, kv_valid):
    q, k, v = _qkv(b, h, sq, sk, d, seed=20)
    do = _randn(23, b, h, sq, d)
    got, want = _grads_both(q, k, v, do, _keep(b, sk, seed=24), kv_valid)
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(w), atol=ATOL, rtol=0)


def test_use_pallas_bwd_route_gradients_match_jax(monkeypatch):
    """With the flag set, a small bias-free, mask-free call's backward is
    row 4 (its plain version here); the gradients are the function's."""
    monkeypatch.setattr(tfa, "USE_PALLAS_BWD", True)
    calls = []
    real = tfa.flash_attention_bwd
    monkeypatch.setattr(tfa, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = _qkv(2, 2, 25, 25, 16, seed=30)
    do = _randn(33, 2, 2, 25, 16)
    got, want = _grads_both(q, k, v, do, None, 21)
    assert calls == [1]
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(w), atol=ATOL, rtol=0)


def test_small_s_route_rule():
    """Below 512² + 1 scores, the JAX route, at any shared memory: a group
    past the resident fp32 kernel's streams."""
    assert tfa.flash_bwd_supported(100, 100, 32)
    assert tfa.flash_bwd_supported(197, 197, 64)
    assert not tfa.flash_bwd_supported(513, 512, 16)   # score budget
    assert tfa.flash_bwd_supported(4, 1000, 64)        # streamed
    assert tfa.flash_bwd_smem_bytes(4, 1000, 64) > tfa._SMEM_LIMIT
    assert tfa.flash_bwd_smem_bytes(197, 197, 64) == 4 * (
        2 * 224 * 65 + 2 * 224 + 2 * 32 * 65 + 2 * 32 * 33)


@pytest.mark.parametrize("dropout_rate", [0.0])
def test_dispatcher_key_padding_mask_matches_jax(monkeypatch, dropout_rate):
    """A (B, 1, 1, Sk) mask at rate 0 rides flash_attention's kv_mask."""
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v = _qkv(2, 2, 12, 18, 8, seed=40)
    mask = _keep(2, 18, seed=41)[:, None, None, :]
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), mask=jnp.asarray(mask))
    got = tattn.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        mask=torch.from_numpy(mask), dropout_rate=dropout_rate)
    assert len(calls) == 1 and calls[0]["kv_mask"].shape == (2, 18)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
