"""Gradients and dropout of the PyTorch port's attention against the JAX
package and against a same-mask oracle.

Inputs come from a numpy seed and feed both packages. On the CPU the port's
``autograd.Function``s run the plain PyTorch versions of the backward
kernels (written out from the kernels' formulas); the JAX Pallas functions
run in interpret mode.

- Rate 0: the port's gradients against ``jax.vjp`` of the JAX functions,
  fp32, 1e-5 absolute (the two packages sum in different orders).
- Dropout on: the TPU's random bits cannot be had on the CPU (the
  interpreter stubs its PRNG), so the port is held against an oracle that is
  given the port's own mask and differentiates by autograd; the mask itself
  is checked for its keep rate, its replay and its dependence on the seed.

The CUDA kernels are held against the plain versions in
tests/test_torch_port_kernels.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.ops import attention as tattn
from vision_transformers_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


def _leaf(a):
    return torch.from_numpy(a).requires_grad_()


# ---------------------------------------------------------------------------
# (a) rate 0 against the JAX package


@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 17, 4, 8, None),    # tiny ViT
    (1, 65, 2, 16, None),   # ViT-tiny CIFAR sequence length
    (2, 40, 2, 16, 33),     # padded sequence, trailing keys masked
])
def test_packed_grad_matches_jax(b, s, heads, dh, kv_valid):
    qkv = _randn(0, b, s, 3 * heads * dh)
    do = _randn(1, b, s, heads * dh)
    want_out, vjp = jax.vjp(
        lambda x: jfa.packed_flash_attention(x, heads, kv_valid=kv_valid),
        jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(do))
    x = _leaf(qkv)
    out = tfa.packed_flash_attention(x, heads, kv_valid=kv_valid)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(out), _np(want_out), atol=ATOL, rtol=0)
    assert x.grad.shape == qkv.shape
    np.testing.assert_allclose(_np(x.grad), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("sq,sk,kv_valid,masked", [
    (16, 16, None, False),
    (24, 10, None, False),   # cross attention, Sq != Sk
    (20, 20, 13, False),     # trailing key padding
    (20, 20, None, True),    # key-padding mask
    (33, 20, 15, True),      # both, and a ragged query tile
])
def test_split_head_grad_matches_jax_dropout_kernel_at_rate_0(sq, sk, kv_valid,
                                                              masked):
    b, h, d = 2, 3, 8
    q, k, v = _randn(2, b, h, sq, d), _randn(3, b, h, sk, d), \
        _randn(4, b, h, sk, d)
    do = _randn(5, b, h, sq, d)
    key_mask = None
    if masked:
        key_mask = np.random.RandomState(6).rand(b, sk) > 0.3
        key_mask[:, 0] = True
    want_out, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_dropout_attention(
            q_, k_, v_, dropout_rate=0.0, seed=jnp.zeros((1,), jnp.int32),
            kv_valid=kv_valid,
            key_mask=None if key_mask is None else jnp.asarray(key_mask)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [_leaf(a) for a in (q, k, v)]
    out = tfa.flash_dropout_attention(
        *leaves, dropout_rate=0.0, seed=None, kv_valid=kv_valid,
        key_mask=None if key_mask is None else torch.from_numpy(key_mask))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(out), _np(want_out), atol=ATOL, rtol=0)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(_np(leaf.grad), _np(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("lead", [None, 1, 2, 4])
@pytest.mark.parametrize("sq,sk,kv_valid", [(16, 16, None), (24, 10, 7)])
def test_flash_attention_grad_matches_jax(lead, sq, sk, kv_valid):
    """dq, dk, dv and dbias of ``flash_attention``; the bias's leading dim is
    1 (shared), n (per window, broadcast over the batch) or B."""
    b, h, d = 4, 3, 8
    q, k, v = _randn(7, b, h, sq, d), _randn(8, b, h, sk, d), \
        _randn(9, b, h, sk, d)
    do = _randn(10, b, h, sq, d)
    arrays = [q, k, v] + ([] if lead is None else [_randn(11, lead, h, sq, sk)])
    _, vjp = jax.vjp(
        lambda *a: jfa.flash_attention(*a, kv_valid=kv_valid),
        *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(do))
    leaves = [_leaf(a) for a in arrays]
    tfa.flash_attention(*leaves, kv_valid=kv_valid).backward(
        torch.from_numpy(do))
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == w.shape
        np.testing.assert_allclose(_np(leaf.grad), _np(w), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# (b) dropout on: the mask, and the port against a same-mask oracle


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox 4x32-10."""
    def run(counter, key):
        words = tfa.philox_4x32(*(torch.tensor([c]) for c in counter), *key)
        return [int(w) for w in words]

    assert run([0] * 4, [0] * 2) == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert run([0xffffffff] * 4, [0xffffffff] * 2) == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert run([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
               [0xa4093822, 0x299f31d0]) == [
        0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_replay_and_seed(rate):
    seed = 12345 + (6 << 40)
    keep = tfa.dropout_keep_mask(seed, rate, 8, 65, 65)
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) <= 3 * sigma
    assert torch.equal(keep, tfa.dropout_keep_mask(seed, rate, 8, 65, 65))
    assert not torch.equal(keep, tfa.dropout_keep_mask(seed + 1, rate, 8, 65,
                                                       65))
    # the high seed word counts too
    assert not torch.equal(keep, tfa.dropout_keep_mask(seed + (1 << 32), rate,
                                                       8, 65, 65))


def test_keep_bit_depends_on_position_only():
    """A keep bit is a function of (seed, group, row, column): the same bit
    whatever the extent of the mask it is drawn in."""
    small = tfa.dropout_keep_mask(7, 0.3, 2, 5, 7)
    large = tfa.dropout_keep_mask(7, 0.3, 6, 33, 18)
    assert torch.equal(small, large[:2, :5, :7])


def test_dropout_threshold_is_the_tpu_rule():
    assert tfa.dropout_threshold(0.0) == 0
    assert tfa.dropout_threshold(0.1) == int(0.1 * 2 ** 32)
    assert tfa.dropout_threshold(0.5) == 2 ** 31
    with pytest.raises(ValueError):
        tfa.dropout_threshold(1.0)


def _oracle_attention(q, k, v, keep, rate, kv_valid=None, key_mask=None):
    """softmax → drop with the given mask → PV, differentiated by autograd:
    independent of the port's backward formulas."""
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    allowed = torch.ones(s.shape[0], 1, 1, s.shape[-1], dtype=torch.bool)
    if kv_valid is not None:
        allowed = allowed & (torch.arange(s.shape[-1]) < kv_valid)
    if key_mask is not None:
        allowed = allowed & key_mask[:, None, None, :]
    s = s.masked_fill(~allowed, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    return torch.matmul(p, v)


@pytest.mark.parametrize("kv_valid", [None, 30])
def test_packed_dropout_matches_same_mask_oracle(kv_valid):
    b, s, heads, dh, rate, seed = 2, 33, 2, 8, 0.2, 99
    qkv = _randn(12, b, s, 3 * heads * dh)
    do = _randn(13, b, s, heads * dh)
    x = _leaf(qkv)
    out = tfa.packed_flash_attention(x, heads, dropout_rate=rate, seed=seed,
                                     kv_valid=kv_valid)
    out.backward(torch.from_numpy(do))

    y = _leaf(qkv)
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2)
               for t in y.split(heads * dh, dim=-1))
    keep = tfa.dropout_keep_mask(seed, rate, b * heads, s, s).view(
        b, heads, s, s)
    want = _oracle_attention(q, k, v, keep, rate, kv_valid)
    want = want.transpose(1, 2).reshape(b, s, heads * dh)
    want.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(out), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(x.grad), _np(y.grad), atol=ATOL, rtol=0)
    # dropout really dropped something, and another seed drops elsewhere
    plain = tfa.packed_flash_attention(torch.from_numpy(qkv), heads,
                                       kv_valid=kv_valid)
    other = tfa.packed_flash_attention(torch.from_numpy(qkv), heads,
                                       dropout_rate=rate, seed=seed + 1,
                                       kv_valid=kv_valid)
    assert (out - plain).abs().max() > 1e-3
    assert (out - other).abs().max() > 1e-3


@pytest.mark.parametrize("sq,sk,kv_valid,masked", [
    (20, 20, None, False), (24, 10, 7, False), (20, 20, 15, True)])
def test_split_head_dropout_matches_same_mask_oracle(sq, sk, kv_valid, masked):
    b, h, d, rate, seed = 2, 3, 8, 0.25, 5 + (1 << 34)
    arrays = [_randn(14, b, h, sq, d), _randn(15, b, h, sk, d),
              _randn(16, b, h, sk, d)]
    do = torch.from_numpy(_randn(17, b, h, sq, d))
    key_mask = None
    if masked:
        key_mask = torch.from_numpy(np.random.RandomState(18).rand(b, sk) > 0.3)
        key_mask[:, 0] = True
    leaves = [_leaf(a) for a in arrays]
    out = tfa.flash_dropout_attention(*leaves, dropout_rate=rate, seed=seed,
                                      kv_valid=kv_valid, key_mask=key_mask)
    out.backward(do)
    oracle = [_leaf(a) for a in arrays]
    keep = tfa.dropout_keep_mask(seed, rate, b * h, sq, sk).view(b, h, sq, sk)
    want = _oracle_attention(*oracle, keep, rate, kv_valid, key_mask)
    want.backward(do)
    np.testing.assert_allclose(_np(out), _np(want), atol=ATOL, rtol=0)
    for leaf, o in zip(leaves, oracle):
        np.testing.assert_allclose(_np(leaf.grad), _np(o.grad), atol=ATOL,
                                   rtol=0)


def test_dropout_needs_a_seed():
    qkv = torch.zeros(1, 4, 3 * 2 * 8)
    with pytest.raises(ValueError, match="seed"):
        tfa.packed_flash_attention(qkv, 2, dropout_rate=0.1)
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_dropout_attention(q, q, q, dropout_rate=0.1, seed=None)
    mod = tattn.SelfAttention(16, 2, attention_dropout=0.1).train()
    with pytest.raises(ValueError, match="seed"):
        mod(torch.zeros(1, 4, 16))
    mod.eval()(torch.zeros(1, 4, 16))  # no dropout at eval: no seed needed


# ---------------------------------------------------------------------------
# Routing with dropout, as vision_transformers_tpu/ops/attention.py:184-216


def test_self_attention_with_dropout_takes_the_packed_path(monkeypatch):
    calls = []
    real = tattn.packed_flash_attention
    monkeypatch.setattr(
        tattn, "packed_flash_attention",
        lambda *a, **k: calls.append(k) or real(*a, **k))
    monkeypatch.setattr(tattn, "dot_product_attention",
                        lambda *a, **k: pytest.fail("split-head path taken"))
    mod = tattn.SelfAttention(32, 4, attention_dropout=0.1).train()
    x = torch.from_numpy(_randn(19, 2, 17, 32))
    out = mod(x, seed=11)
    assert calls == [dict(dropout_rate=0.1, seed=11)]
    assert torch.equal(out, mod(x, seed=11))          # replay
    assert not torch.equal(out, mod(x, seed=12))
    mod.eval()
    mod(x)
    assert calls[-1] == dict(dropout_rate=0.0, seed=None)


def test_self_attention_with_dropout_at_large_s_takes_the_dropout_kernel(
        monkeypatch):
    calls = []
    real = tattn.flash_dropout_attention
    monkeypatch.setattr(
        tattn, "flash_dropout_attention",
        lambda *a, **k: calls.append(k["dropout_rate"]) or real(*a, **k))
    monkeypatch.setattr(tattn, "packed_flash_attention",
                        lambda *a, **k: pytest.fail("packed path taken"))
    mod = tattn.SelfAttention(768, 12, attention_dropout=0.1).train()
    out = mod(torch.from_numpy(_randn(20, 1, 1025, 768)), seed=3)
    assert calls == [0.1] and out.shape == (1, 1025, 768)


@pytest.mark.parametrize("masked", [False, True])
def test_dispatcher_dropout_branch(masked):
    """Bias-free dropout, with an optional key-padding mask, rides
    ``flash_dropout_attention`` with a seed drawn from the generator."""
    b, h, s, d = 2, 2, 12, 8
    q, k, v = (torch.from_numpy(_randn(21 + i, b, h, s, d)) for i in range(3))
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.RandomState(24).rand(b, 1, 1, s) > 0.3)
        mask[..., 0] = True
    gen = torch.Generator().manual_seed(5)
    got = tattn.dot_product_attention(q, k, v, mask=mask, dropout_rate=0.3,
                                      generator=gen)
    seed = tattn.draw_seed(torch.Generator().manual_seed(5))
    want = tfa.flash_dropout_attention(
        q, k, v, dropout_rate=0.3, seed=seed,
        key_mask=None if mask is None else mask[:, 0, 0, :])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# remat replays the masks


def test_remat_gives_the_same_gradients_as_no_remat():
    cfg = dict(image_size=16, patch_size=4, num_layers=2, num_heads=4,
               hidden_dim=64, mlp_dim=128, num_classes=10, dropout=0.1,
               attention_dropout=0.1, device="cpu", seed=3)
    x = torch.from_numpy(_randn(25, 4, 16, 16, 3))
    grads, feats = [], []
    for remat in (False, True):
        model = ViT(**cfg, remat=remat).train()
        model.dropout_generator.manual_seed(8)
        f = model.forward_features(x)
        f.square().sum().backward()
        feats.append(f.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert torch.equal(feats[0], feats[1])
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 20
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
    # dropout is on: eval features differ
    assert not torch.equal(feats[0], model.eval().forward_features(x))
