"""The PyTorch port's attention against the JAX package.

Inputs come from a numpy seed and feed both packages. On the CPU the port's
wrappers take their plain PyTorch versions; the JAX Pallas functions run in
interpret mode, as tests/test_flash_attention.py runs them. Tolerances are
fp32: 1e-5 absolute on attention outputs of O(1) magnitude (the two
packages sum in different orders).

The CUDA kernels themselves are held against their plain versions in
tests/test_torch_port_kernels.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops import attention as jattn
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.ops import attention as tattn
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

ATOL = 1e-5


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 17, 4, 8, None),    # tiny ViT
    (1, 65, 2, 16, None),   # ViT-tiny CIFAR sequence length
    (2, 40, 2, 16, 33),     # padded sequence, trailing keys masked
    (3, 50, 2, 32, 50),     # kv_valid == S is no mask
])
def test_packed_matches_jax(b, s, heads, dh, kv_valid):
    qkv = _randn(0, b, s, 3 * heads * dh)
    want = jfa.packed_flash_attention(jnp.asarray(qkv), heads,
                                      kv_valid=kv_valid)
    got = tfa.packed_flash_attention(torch.from_numpy(qkv), heads,
                                     kv_valid=kv_valid)
    assert got.shape == (b, s, heads * dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_packed_lse_matches_jax():
    b, s, heads, dh = 2, 23, 3, 8
    qkv = _randn(1, b, s, 3 * heads * dh)
    scale = dh ** -0.5
    _, want = jfa._packed_fwd(jnp.asarray(qkv), heads, scale, kv_valid=19)
    _, got = tfa.packed_flash_attention_fwd(torch.from_numpy(qkv), heads,
                                            scale, kv_valid=19)
    assert got.shape == (b, s, heads) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_packed_kv_valid_hides_poisoned_tail():
    b, s_real, pad, heads, dh = 2, 21, 5, 2, 8
    qkv = _randn(2, b, s_real + pad, 3 * heads * dh)
    hd = heads * dh
    qkv[:, s_real:, hd:] = 1e6  # pad keys and values
    got = tfa.packed_flash_attention(torch.from_numpy(qkv), heads,
                                     kv_valid=s_real)
    ref = tfa.packed_flash_attention(torch.from_numpy(qkv[:, :s_real].copy()),
                                     heads)
    np.testing.assert_allclose(_np(got[:, :s_real]), _np(ref), atol=ATOL,
                               rtol=0)


def _bias_case(kind, b, h, sq, sk):
    lead = {"shared": 1, "per_window": b // 2, "per_batch": b}[kind]
    return _randn(7, lead, h, sq, sk)


@pytest.mark.parametrize("kind", [None, "shared", "per_window", "per_batch"])
@pytest.mark.parametrize("sq,sk,kv_valid", [
    (16, 16, None),
    (24, 10, None),   # cross attention, Sq != Sk (SRA)
    (20, 20, 13),     # trailing key padding
])
def test_flash_matches_jax(kind, sq, sk, kv_valid):
    b, h, d = 4, 3, 8
    q, k, v = _randn(3, b, h, sq, d), _randn(4, b, h, sk, d), \
        _randn(5, b, h, sk, d)
    bias = None if kind is None else _bias_case(kind, b, h, sq, sk)
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), kv_valid=kv_valid)
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), kv_valid=kv_valid)
    assert got.shape == (b, h, sq, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_flash_lse_matches_jax():
    b, h, sq, sk, d = 2, 2, 12, 9, 8
    q, k, v = _randn(8, b, h, sq, d), _randn(9, b, h, sk, d), \
        _randn(10, b, h, sk, d)
    bias = _randn(11, 1, h, sq, sk)
    g = b * h
    _, want = jfa._flash_fwd(
        jnp.asarray(q.reshape(g, sq, d)), jnp.asarray(k.reshape(g, sk, d)),
        jnp.asarray(v.reshape(g, sk, d)), jnp.asarray(bias.reshape(h, sq, sk)),
        None, d ** -0.5, 7, 256)
    _, got = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), kv_valid=7)
    np.testing.assert_allclose(_np(got).reshape(g, sq), _np(want)[..., 0],
                               atol=ATOL, rtol=0)


def test_flash_rejects_bias_not_dividing_batch():
    q = torch.zeros(4, 2, 8, 8)
    with pytest.raises(ValueError, match="dividing"):
        tfa.flash_attention(q, q, q, torch.zeros(3, 2, 8, 8))


@pytest.mark.parametrize("s", [17, 65, 197, 208, 257, 577, 1025])
@pytest.mark.parametrize("hd,itemsize", [(192, 2), (768, 2), (768, 4),
                                         (1024, 2)])
def test_packed_supported_matches_jax(s, hd, itemsize):
    for b in (1, 32):
        assert tfa.packed_flash_supported(b, s, 3 * hd, itemsize) == \
            jfa.packed_flash_supported(b, s, 3 * hd, itemsize)


@pytest.mark.parametrize("case", ["plain", "mask", "kv_valid", "window_bias"])
def test_dot_product_attention_matches_jax(case):
    b, h, s, d = 4, 2, 12, 8
    q, k, v = _randn(12, b, h, s, d), _randn(13, b, h, s, d), \
        _randn(14, b, h, s, d)
    kw = {}
    if case == "mask":
        m = np.random.RandomState(15).rand(b, 1, s, s) > 0.3
        m[..., 0] = True
        kw["mask"] = m
    elif case == "kv_valid":
        kw["kv_valid"] = 9
    elif case == "window_bias":
        kw["bias"] = _randn(16, 2, h, s, s)
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()})
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **{n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()})
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("return_weights", [False, True])
def test_self_attention_matches_jax(return_weights):
    import jax

    b, s, hd, heads = 2, 17, 32, 4
    x = _randn(17, b, s, hd)
    jmod = jattn.SelfAttention(hidden_dim=hd, num_heads=heads)
    params = jax.device_get(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    rng = np.random.RandomState(18)  # nonzero biases, so they are checked
    params["qkv"]["bias"] = rng.randn(3 * hd).astype(np.float32) * 0.1
    params["out"]["bias"] = rng.randn(hd).astype(np.float32) * 0.1
    tmod = tattn.SelfAttention(hd, heads)
    tmod.load_state_dict(vit_state_dict_from_jax(params))
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      return_weights=return_weights)
    got = tmod(torch.from_numpy(x), return_weights=return_weights)
    if return_weights:
        (want, want_w), (got, got_w) = want, got
        assert got_w.shape == (b, heads, s, s)
        np.testing.assert_allclose(_np(got_w), _np(want_w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_self_attention_routes_large_s_to_split_head(monkeypatch):
    """S = 1025 at ViT-B width fails packed_flash_supported, as in JAX: the
    module must call flash_attention, not the packed kernel."""
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tattn, "packed_flash_attention",
                        lambda *a, **k: pytest.fail("packed path taken"))
    mod = tattn.SelfAttention(768, 12)
    out = mod(torch.from_numpy(_randn(19, 1, 1025, 768)))
    assert calls == [1] and out.shape == (1, 1025, 768)


def test_cpu_tensors_never_count_as_kernel_launches():
    tfa.reset_launch_counts()
    qkv = torch.from_numpy(_randn(20, 1, 9, 3 * 2 * 8))
    tfa.packed_flash_attention(qkv, 2)
    q = torch.from_numpy(_randn(21, 1, 2, 9, 8))
    tfa.flash_attention(q, q, q)
    q.requires_grad_()
    tfa.flash_dropout_attention(q, q, q, dropout_rate=0.1,
                                seed=1).sum().backward()
    assert set(tfa.LAUNCHES) == {
        "packed_attention", "flash_attention", "packed_attention_bwd",
        "dropout_attention_fwd", "dropout_attention_bwd"}
    assert not any(tfa.LAUNCHES.values())
