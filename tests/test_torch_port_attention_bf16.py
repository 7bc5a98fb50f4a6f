"""The split-head plain versions against the JAX package in bf16.

The bf16 CUDA kernels of rows 2 and 6 (``csrc/attention_mma_tile.cuh``,
``csrc/attention_bwd_mma_tile.cuh``) round where the TPU kernels round: the
probabilities to the value dtype before P·V in the forward (``_attn_kernel``,
``_drop_fwd_kernel``), pd and ds to the input dtype before their products in
the backward (``_drop_bwd_kernel``). The kernels are held against the port's
plain versions on the card (tests/test_torch_port_kernels.py); here the plain
versions are held against the JAX package's Pallas kernels, run in interpret
mode on the CPU as tests/test_flash_dropout.py runs them, on the same bf16
inputs (numpy draws rounded to bf16 on both sides).

Tolerances: both sides round at the same points, so what is left is fp32
summation order moving a bf16 rounding by one step. So every element is
within 1/128 of the largest reference element (one bf16 step at magnitudes
1-2, as here), and at most 2% of the elements differ at all: moving one
rounding point (rounding P after P·V, or not rounding ds) flips many more
of them by a step at these shapes, and fails every case here, while the two
packages agree bit for bit here. The fp32 lse: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.ops import flash_attention as tfa

REL_TOL = 1.0 / 128
DIFFERING_MAX = 0.02  # share of elements that may differ by one step
LSE_ATOL = 1e-5


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = REL_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert np.mean(got != want) <= DIFFERING_MAX


def _pair(a):
    """One numpy array as a bf16 JAX array and a bf16 torch tensor."""
    return jnp.asarray(a, dtype=jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def _key_mask(b, sk, seed=6):
    m = np.random.RandomState(seed).rand(b, sk) > 0.3
    m[:, 0] = True
    return m


@pytest.mark.parametrize("kind,sq,sk,kv_valid", [
    (None, 16, 16, None),
    ("shared", 24, 10, None),    # cross attention, Sq != Sk
    ("per_batch", 20, 20, 13),   # trailing key padding
])
def test_flash_reference_matches_jax_kernel_in_bf16(kind, sq, sk, kv_valid):
    """``flash_attention_reference`` against ``_attn_kernel`` (through
    ``_flash_fwd``), both in bf16: out and the fp32 lse."""
    b, h, d = 2, 2, 16
    g = b * h
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_randn(s, b, h, n, d)) for s, n in
                                    ((1, sq), (2, sk), (3, sk)))
    bias = None
    if kind is not None:
        bias = _randn(4, 1 if kind == "shared" else b, h, sq, sk)
    want, want_lse = jfa._flash_fwd(
        jq.reshape(g, sq, d), jk.reshape(g, sk, d), jv.reshape(g, sk, d),
        None if bias is None else jnp.asarray(bias.reshape(-1, sq, sk)),
        None, d ** -0.5, sk if kv_valid is None else kv_valid, 256)
    got, got_lse = tfa.flash_attention_reference(
        tq, tk, tv, None if bias is None else torch.from_numpy(bias),
        kv_valid=kv_valid)
    assert got.dtype == torch.bfloat16
    _close(got.reshape(g, sq, d), want)
    np.testing.assert_allclose(_np(got_lse).reshape(g, sq),
                               _np(want_lse)[..., 0],
                               atol=LSE_ATOL, rtol=0)


def _jax_dropout_call(jq, jk, jv, key_mask, kv_valid, **kw):
    """``_dropout_attn_call`` at rate 0 on (G, S, D) views."""
    b, h, sq, d = jq.shape
    sk = jk.shape[2]
    g = b * h
    mask_add = None
    if key_mask is not None:
        mask_add = jnp.broadcast_to(
            jnp.where(jnp.asarray(key_mask), 0.0, jfa.DEFAULT_MASK_VALUE)
            .astype(jnp.float32)[:, None, None, :], (b, h, 1, sk)
        ).reshape(g, 1, sk)
    return jfa._dropout_attn_call(
        jq.reshape(g, sq, d), jk.reshape(g, sk, d), jv.reshape(g, sk, d),
        jnp.zeros((1,), jnp.int32), d ** -0.5,
        sk if kv_valid is None else kv_valid, 0.0, mask_add=mask_add, **kw)


@pytest.mark.parametrize("sq,sk,kv_valid,masked", [
    (16, 16, None, False),
    (24, 10, None, False),   # cross attention, Sq != Sk
    (33, 20, 15, True),      # kv_valid and a key mask, ragged query tile
])
def test_dropout_references_match_jax_kernels_in_bf16(sq, sk, kv_valid,
                                                      masked):
    """``flash_dropout_attention_reference`` against ``_drop_fwd_kernel`` and
    ``flash_dropout_attention_bwd_reference`` against ``_drop_bwd_kernel``,
    at rate 0 in bf16; both backwards start from the JAX forward's (out,
    lse), so only the backward's arithmetic is compared."""
    b, h, d = 2, 2, 16
    g = b * h
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_randn(s, b, h, n, d)) for s, n in
                                    ((7, sq), (8, sk), (9, sk)))
    jdo, tdo = _pair(_randn(10, b, h, sq, d))
    key_mask = _key_mask(b, sk) if masked else None
    t_mask = None if key_mask is None else torch.from_numpy(key_mask)
    kw = dict(dropout_rate=0.0, seed=None, kv_valid=kv_valid, key_mask=t_mask)

    j_out, j_lse = _jax_dropout_call(jq, jk, jv, key_mask, kv_valid,
                                     backward=False)
    t_out, t_lse = tfa.flash_dropout_attention_reference(tq, tk, tv, **kw)
    _close(t_out.reshape(g, sq, d), j_out)
    np.testing.assert_allclose(_np(t_lse).reshape(g, sq),
                               _np(j_lse)[..., 0], atol=LSE_ATOL, rtol=0)

    want = _jax_dropout_call(jq, jk, jv, key_mask, kv_valid, backward=True,
                             do=jdo.reshape(g, sq, d), out=j_out, lse=j_lse)
    got = tfa.flash_dropout_attention_bwd_reference(
        tq, tk, tv, tdo,
        torch.from_numpy(_np(j_out).copy()).to(torch.bfloat16).reshape(
            b, h, sq, d),
        torch.from_numpy(_np(j_lse)[..., 0].copy()).reshape(b, h, sq), **kw)
    for gr, w, n in zip(got, want, (sq, sk, sk)):
        assert gr.dtype == torch.bfloat16
        _close(gr.reshape(g, n, d), w)


@pytest.mark.parametrize("groups,s_q,s_k", [
    (32, 3136, 49),     # PVT stage 1: 32 key blocks → split
    (16, 100, 100),     # the DETR decoder's self attention in training
    (96, 1025, 1025),   # ViT-B/16 @512: fills the card, no split
    (16, 4704, 4704),   # the DETR encoder
    (2, 33, 33),        # one query tile: nothing to split
    (1, 70000, 16),
])
def test_dkv_chunks_split_the_query_loop_into_nonempty_ranges(groups, s_q,
                                                              s_k):
    """The bf16 backward's dk/dv pass: ``dkv_chunks`` ranges of ``per``
    query tiles each, as the C entry cuts them, every one non-empty; a split
    only where G·ceil(Sk/64) blocks cannot fill the card twice."""
    chunks = tfa.dkv_chunks(groups, s_q, s_k)
    nq = -(-s_q // 64)
    blocks = groups * -(-s_k // 64)
    assert 1 <= chunks <= nq
    per = -(-nq // chunks)
    assert -(-nq // per) == chunks and (chunks - 1) * per < nq
    assert (chunks > 1) == (blocks < 264 and nq > 1)
    assert tfa.dkv_chunks(groups, s_q, s_k) == chunks  # shape alone
