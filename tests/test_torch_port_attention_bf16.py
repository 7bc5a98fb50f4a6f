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

The packed forward (row 1, ``csrc/packed_attention.cu``) runs on the same
tensor-core tile in bf16 and rounds the unnormalised probabilities before
P·V, as ``_packed_fwd_kernel`` does: its plain version is held against
``_packed_fwd`` here in bf16 the same way, at rate 0 (the interpreter has
no TPU PRNG), with trailing keys past ``kv_valid``. Its backward (row 7)
runs on the tensor-core backward of row 6 with the packed strides and rounds
pd and ds to bf16 before their products, as ``_packed_bwd_kernel`` does:
its plain version is held against ``_packed_bwd_pallas`` the same way, both
from the JAX forward's (out, lse).

The small-S backward (row 4, ``csrc/flash_attention_bwd.cu``) runs on the
tensor-core backward of row 6 in bf16 with ``_bwd_kernel``'s rounding: ds
rounded before the scale, pᵀ before dv, dq and dk scaled in fp32 before
their rounding. Its plain version is held against ``_flash_bwd_pallas``
here at D 32 and 16, where the scale is not a power of two, beside the
other order (ds·scale rounded, rows 6 and 7's), which must fail there.

The per-window forward (row 9, ``csrc/window_attention.cu``) and the shared
window backward (row 10, ``csrc/window_attention_bwd.cu``) run on the tensor
cores in bf16 (``csrc/window_mma_tile.cuh``) and round where
``_window_pack_kernel`` and ``_window_pack_bwd_kernel`` round: s = q·kᵀ
scaled in fp32, p normalised and then rounded before P·V; p in fp32 for δ
and ds, ds·scale rounded for dq and dk, p rounded for dv. Their plain
versions are held against ``_window_pack_fwd_pallas`` and
``_window_pack_bwd_pallas`` here at N 49, dh 32 (scale 1/√32, not a power
of two) with a per-window bias, beside the tempting wrong orders, which must
fail the same limits: q·scale rounded before the product, p rounded
unnormalised with the division after P·V; ds rounded before the scale for dq
and dk, δ taken from the rounded p. Each of them moves a quarter to a half
of the elements by a step. ``window_route`` sends bf16 to the tensor cores at
every shape the window kernels take, fp32 to the CUDA cores.

The masked streaming forward (row 3, ``csrc/flash_attention_large.cu``) on
the tensor cores rounds the unnormalised probabilities before P·V, as
``_large_kernel`` does: its plain version is held against
``_flash_fwd_large`` here in bf16 the same way, at key counts of one Pallas
block (512), where both take one global max.

The bf16 kernels of rows 3 and 5 skip 64-key tiles whose keys are all
hidden. That rests on an identity of the function, tested here on the plain
versions in fp32: keys hidden from n on give the output of the same call on
K/V truncated to n keys. A hidden key's probability is exactly 0 in fp32
(exp(-0.7·FLT_MAX - m) underflows), so what is left is the summation order
of a longer row: 1e-6 on outputs of magnitude below 3 and on lse.
"""

import pathlib
import re

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


@pytest.mark.parametrize("b,h,sq,sk,d,kv_valid", [
    (2, 2, 33, 70, 16, 60),     # ragged Sq, kv_valid < Sk, cross attention
    (1, 3, 130, 200, 32, None),  # queries over one 128-block
    (2, 1, 9, 130, 8, 120),
])
def test_large_reference_matches_jax_kernel_in_bf16(b, h, sq, sk, d,
                                                    kv_valid):
    """``flash_attention_large_reference`` against ``_large_kernel`` (through
    ``_flash_fwd_large``), both in bf16, with a keep mask per image: out and
    the fp32 lse. Both round the unnormalised probabilities before P·V."""
    g = b * h
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_randn(s, b, h, n, d)) for s, n in
                                    ((11, sq), (12, sk), (13, sk)))
    keep = _key_mask(b, sk, seed=14)
    want, want_lse = jfa._flash_fwd_large(
        jq.reshape(g, sq, d), jk.reshape(g, sk, d), jv.reshape(g, sk, d),
        d ** -0.5, sk if kv_valid is None else kv_valid,
        kv_mask=jnp.asarray(keep), heads=h)
    got, got_lse = tfa.flash_attention_large_reference(
        tq, tk, tv, kv_mask=torch.from_numpy(keep), kv_valid=kv_valid)
    assert got.dtype == torch.bfloat16
    _close(got.reshape(g, sq, d), _np(want)[:, :sq])
    np.testing.assert_allclose(_np(got_lse).reshape(g, sq),
                               _np(want_lse)[:, :sq, 0], atol=LSE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 24, 2, 16, 19),
    (2, 33, 3, 32, 29),    # ragged S
    (1, 40, 2, 32, 37),
])
def test_packed_reference_matches_jax_kernel_in_bf16(b, s, heads, dh,
                                                     kv_valid):
    """``packed_flash_attention_reference`` against ``_packed_fwd_kernel``
    (through ``_packed_fwd``), both in bf16 at rate 0, keys >= kv_valid
    hidden: out (B, S, H·dh) and the fp32 lse (B, S, H)."""
    jqkv, tqkv = _pair(_randn(40, b, s, 3 * heads * dh))
    want, want_lse = jfa._packed_fwd(jqkv, heads, dh ** -0.5,
                                     kv_valid=kv_valid)
    got, got_lse = tfa.packed_flash_attention_reference(tqkv, heads,
                                                        kv_valid=kv_valid)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, heads * dh)
    _close(got, want)
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=LSE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 24, 2, 16, 19),
    (2, 33, 3, 32, 29),    # ragged S
    (1, 40, 2, 32, 37),
])
def test_packed_bwd_reference_matches_jax_kernel_in_bf16(b, s, heads, dh,
                                                         kv_valid):
    """``packed_flash_attention_bwd_reference`` against
    ``_packed_bwd_kernel`` (through ``_packed_bwd_pallas``), both in bf16 at
    rate 0 from the JAX forward's (out, lse), keys >= kv_valid hidden:
    dqkv (B, S, 3·H·dh), its q, k and v thirds each."""
    jqkv, tqkv = _pair(_randn(41, b, s, 3 * heads * dh))
    jdo, tdo = _pair(_randn(42, b, s, heads * dh))
    scale = dh ** -0.5
    j_out, j_lse = jfa._packed_fwd(jqkv, heads, scale, kv_valid=kv_valid)
    want = jfa._packed_bwd_pallas(jqkv, jdo, j_out, j_lse, heads, scale,
                                  kv_valid=kv_valid)
    got = tfa.packed_flash_attention_bwd_reference(
        tqkv, tdo, torch.from_numpy(_np(j_out).copy()).to(torch.bfloat16),
        torch.from_numpy(_np(j_lse).copy()), heads, kv_valid=kv_valid)
    assert got.dtype == torch.bfloat16 and got.shape == tqkv.shape
    hd = heads * dh
    for i in range(3):
        _close(got[..., i * hd:(i + 1) * hd], _np(want)[..., i * hd:(i + 1) * hd])
    # the hidden keys' dk and dv are exactly 0
    assert not got[:, kv_valid:, hd:].float().abs().max().item()


def _within(got, want):
    """``_close`` as a truth value."""
    got, want = _np(got), _np(want)
    tol = REL_TOL * max(1.0, float(np.abs(want).max()))
    return bool(np.abs(got - want).max() <= tol
                and np.mean(got != want) <= DIFFERING_MAX)


def _small_bwd_rounding_ds_scaled(q, k, v, out, lse, do, scale, kv_valid):
    """``flash_attention_bwd_reference`` with ds·scale rounded to bf16
    instead of ds (the order of rows 6 and 7): what the test below must
    tell from ``_bwd_kernel``'s rounding."""
    f = lambda t: t.float()  # noqa: E731
    s = f(q) @ f(k).transpose(-1, -2) * scale
    s[..., kv_valid:] = tfa.DEFAULT_MASK_VALUE
    p = torch.exp(s - lse.unsqueeze(-1))
    delta = (f(do) * f(out)).sum(-1, keepdim=True)
    ds = (p * (f(do) @ f(v).transpose(-1, -2) - delta) * scale).to(
        q.dtype).float()
    dv = p.to(q.dtype).float().transpose(-1, -2) @ f(do)
    return ((ds @ f(k)).to(q.dtype), (ds.transpose(-1, -2) @ f(q)).to(q.dtype),
            dv.to(q.dtype))


@pytest.mark.parametrize("b,h,sq,sk,d,kv_valid", [
    (2, 2, 40, 40, 32, None),  # the DETR decoder's D 32, narrow
    (1, 3, 33, 17, 32, None),  # Sq != Sk
    (2, 2, 24, 24, 32, 19),    # kv_valid < Sk
    (1, 3, 33, 17, 16, None),  # scale 0.25: the two orders agree
])
def test_small_bwd_reference_matches_jax_kernel_in_bf16(b, h, sq, sk, d,
                                                        kv_valid):
    """``flash_attention_bwd_reference`` against ``_bwd_kernel`` (through
    ``_flash_bwd_pallas``), both in bf16 from the JAX forward's (out, lse):
    ds rounded before the scale, pᵀ before dv, dq and dk scaled in fp32,
    the rounding row 4's tensor-core kernels keep. At D 32 the scale 1/√32
    is not a power of two, so rounding ds·scale instead (rows 6 and 7's
    order) moves about half the elements of dq and dk by a step, and fails
    the same limits; at D 16 and 64 (0.25, 0.125) the two orders give the
    same bits."""
    g = b * h
    kvv = sk if kv_valid is None else kv_valid
    scale = d ** -0.5
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_randn(s, b, h, n, d)) for s, n in
                                    ((51, sq), (52, sk), (53, sk)))
    jdo, tdo = _pair(_randn(54, b, h, sq, d))
    j_out, j_lse = jfa._flash_fwd(
        jq.reshape(g, sq, d), jk.reshape(g, sk, d), jv.reshape(g, sk, d),
        None, None, scale, kvv, 256)
    want = jfa._flash_bwd_pallas(
        jq.reshape(g, sq, d), jk.reshape(g, sk, d), jv.reshape(g, sk, d),
        j_out, j_lse, jdo.reshape(g, sq, d), scale, kvv)
    t_out = torch.from_numpy(_np(j_out).copy()).to(torch.bfloat16).reshape(
        b, h, sq, d)
    t_lse = torch.from_numpy(_np(j_lse)[..., 0].copy()).reshape(b, h, sq)
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, t_out, t_lse, tdo,
                                            kv_valid=kv_valid)
    fault = _small_bwd_rounding_ds_scaled(tq, tk, tv, t_out, t_lse, tdo,
                                          scale, kvv)
    for gr, w, n in zip(got, want, (sq, sk, sk)):
        assert gr.dtype == torch.bfloat16
        _close(gr.reshape(g, n, d), w)
    # dv does not see ds; dq and dk tell the two orders apart at D 32
    for f, gr, w, n in zip(fault[:2], got[:2], want[:2], (sq, sk)):
        if d == 32:
            assert not _within(f.reshape(g, n, d), w)
        else:
            assert torch.equal(f, gr)


SKIP_ATOL = 1e-6


def _hidden_from(b, sk, n, seed):
    """A random keep mask over keys [0, n) (key 0 kept) and keys >= n
    hidden."""
    keep = _key_mask(b, sk, seed)
    keep[:, n:] = False
    return torch.from_numpy(keep)


@pytest.mark.parametrize("sq,sk,n,d", [(40, 200, 128, 16), (70, 130, 64, 32),
                                       (33, 300, 192, 64)])
def test_large_reference_keys_hidden_from_n_equal_truncation(sq, sk, n, d):
    """Row 3's plain version: keys hidden from n on (mask and kv_valid)
    against the call on K/V truncated to n, in fp32."""
    b, h = 2, 2
    q, k, v = (torch.from_numpy(_randn(20 + i, b, h, s, d))
               for i, s in enumerate((sq, sk, sk)))
    keep = _hidden_from(b, sk, n, seed=23)
    for kw, cut in (({"kv_mask": keep}, {"kv_mask": keep[:, :n]}),
                    ({"kv_valid": n}, {})):
        out, lse = tfa.flash_attention_large_reference(q, k, v, **kw)
        want, want_lse = tfa.flash_attention_large_reference(
            q, k[:, :, :n], v[:, :, :n], **cut)
        np.testing.assert_allclose(_np(out), _np(want), atol=SKIP_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_np(lse), _np(want_lse), atol=SKIP_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk,n,d", [(40, 200, 128, 16), (33, 300, 192, 64)])
def test_dropout_reference_keys_hidden_from_n_equal_truncation(rate, sq, sk,
                                                               n, d):
    """Row 5's plain version: keys hidden from n on by the key mask against
    the call on K/V truncated to n, in fp32; the dropout bits of a column
    depend on nothing but (seed, group, row, column), so both calls drop the
    same probabilities."""
    b, h = 2, 2
    q, k, v = (torch.from_numpy(_randn(30 + i, b, h, s, d))
               for i, s in enumerate((sq, sk, sk)))
    keep = _hidden_from(b, sk, n, seed=33)
    kw = dict(dropout_rate=rate, seed=2024 + (7 << 35))
    out, lse = tfa.flash_dropout_attention_reference(q, k, v, key_mask=keep,
                                                     **kw)
    want, want_lse = tfa.flash_dropout_attention_reference(
        q, k[:, :, :n], v[:, :, :n], key_mask=keep[:, :n], **kw)
    np.testing.assert_allclose(_np(out), _np(want), atol=SKIP_ATOL, rtol=0)
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=SKIP_ATOL,
                               rtol=0)


def test_key_mask_add_writes_the_kernels_mask_value_bit_for_bit():
    """Row 5's bf16 kernel tells a hidden key by comparing its mask value
    with the fp32 constant kMaskValue of ``csrc/attention_tile.cuh`` bit for
    bit (a tile of hidden keys past the last attended one is skipped), so
    ``_key_mask_add`` must write exactly -0.7f·FLT_MAX, rounded in fp32 as
    the C expression is, for a hidden key and 0 for a kept one; and both
    must be the JAX package's DEFAULT_MASK_VALUE."""
    src = (pathlib.Path(tfa.__file__).parent.parent / "csrc"
           / "attention_tile.cuh").read_text()
    assert re.search(r"constexpr float kMaskValue = "
                     r"-0\.7f \* 3\.40282346638528859812e\+38f;", src)
    hidden = (np.float32(-0.7) * np.float32(3.40282346638528859812e+38)
              ).view(np.uint32)
    got = tfa._key_mask_add(torch.tensor([[True, False, True, False]]))
    assert got.dtype == torch.float32
    assert got.numpy().view(np.uint32).tolist() == [[0, hidden, 0, hidden]]
    assert np.float32(jfa.DEFAULT_MASK_VALUE).view(np.uint32) == hidden


def _window_qkv(seed, g, n, heads, dh, nwp):
    """bf16 qkv (G, N, 3·H·dh) on both sides, and an fp32 (nW', H, N, N)
    bias."""
    jqkv, tqkv = _pair(_randn(seed, g, n, 3 * heads * dh))
    return jqkv, tqkv, _randn(seed + 1, nwp, heads, n, n)


def _window_scores(tqkv, bias, heads, q_scaled_bf16=False):
    """q, k, v (G, H, N, dh) in fp32 and the fp32 scores with the bias
    rounded to bf16, as ``window_attention_reference`` forms them; with
    ``q_scaled_bf16`` q·scale rounded to bf16 before the product instead."""
    g, n, c3 = tqkv.shape
    dh = c3 // (3 * heads)
    scale = dh ** -0.5
    q, k, v = (t.reshape(g, n, heads, dh).transpose(1, 2).float()
               for t in tqkv.split(c3 // 3, dim=-1))
    if q_scaled_bf16:
        s = (q * scale).to(torch.bfloat16).float() @ k.transpose(-1, -2)
    else:
        s = q @ k.transpose(-1, -2) * scale
    nw = bias.shape[0]
    b = torch.from_numpy(bias).to(torch.bfloat16).float()
    s = (s.reshape(g // nw, nw, heads, n, n) + b).reshape(g, heads, n, n)
    return q, k, v, s


def _merge(t):
    """(G, H, N, dh) fp32 → (G, N, H·dh) bf16."""
    g, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(g, n, h * dh).to(torch.bfloat16)


@pytest.mark.parametrize("g,heads,nwp", [(16, 3, 4), (12, 2, 3)])
def test_window_reference_matches_jax_kernel_in_bf16(g, heads, nwp):
    """``window_attention_reference`` against ``_window_pack_kernel``
    (through ``_window_pack_fwd_pallas``), both in bf16 at N 49, dh 32 with
    a per-window bias; the two wrong rounding orders fail the same limits."""
    n, dh = 49, 32
    jqkv, tqkv, bias = _window_qkv(70, g, n, heads, dh, nwp)
    p, g_blk = jfa.window_pack_plan(g, n, heads, dh, nwp, 2)
    want = jfa._window_pack_fwd_pallas(jqkv, jnp.asarray(bias), heads,
                                       dh ** -0.5, p, g_blk)
    got = tfa.window_attention_reference(tqkv, torch.from_numpy(bias), heads)
    assert got.dtype == torch.bfloat16
    _close(got, want)

    _, _, v, s = _window_scores(tqkv, bias, heads, q_scaled_bf16=True)
    q_rounded = _merge(torch.softmax(s, -1).to(torch.bfloat16).float() @ v)
    _, _, v, s = _window_scores(tqkv, bias, heads)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    divided_after = _merge((e.to(torch.bfloat16).float() @ v)
                           / e.sum(-1, keepdim=True))
    for wrong in (q_rounded, divided_after):
        assert not _within(wrong, want)


@pytest.mark.parametrize("g,heads,nwp", [(16, 3, 4), (12, 2, 3)])
def test_window_bwd_reference_matches_jax_kernel_in_bf16(g, heads, nwp):
    """``window_attention_bwd_reference`` against ``_window_pack_bwd_kernel``
    (through ``_window_pack_bwd_pallas``), both in bf16 at N 49, dh 32 with
    a per-window bias: dqkv's q, k and v thirds and dbias. ds rounded before
    the scale, or δ taken from the rounded p, fails the same limits in dq and
    dk (dv does not see ds)."""
    n, dh = 49, 32
    scale = dh ** -0.5
    jqkv, tqkv, bias = _window_qkv(72, g, n, heads, dh, nwp)
    jdo, tdo = _pair(_randn(74, g, n, heads * dh))
    want, want_db = jfa._window_pack_bwd_pallas(
        jqkv, jnp.asarray(bias), jdo, heads, scale,
        jfa.window_pack_plan(g, n, heads, dh, nwp, 2)[0],
        jfa._window_pack_bwd_gblk(g, n, heads, dh, nwp, 2))
    got, got_db = tfa.window_attention_bwd_reference(
        tqkv, torch.from_numpy(bias), tdo, heads)
    assert got.dtype == torch.bfloat16 and got.shape == tqkv.shape
    hd = heads * dh
    want = _np(want)
    for i in range(3):
        _close(got[..., i * hd:(i + 1) * hd], want[..., i * hd:(i + 1) * hd])
    _close(got_db, want_db)

    q, k, v, s = _window_scores(tqkv, bias, heads)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    do = tdo.reshape(g, n, heads, dh).transpose(1, 2).float()
    dp = do @ v.transpose(-1, -2)
    p_c = p.to(torch.bfloat16).float()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_c = ds.to(torch.bfloat16).float()  # rounded before the scale
    wrong = [(ds_c @ k * scale, ds_c.transpose(-1, -2) @ q * scale)]
    ds = p * (dp - (dp * p_c).sum(-1, keepdim=True))  # δ of the rounded p
    ds_c = (ds * scale).to(torch.bfloat16).float()
    wrong.append((ds_c @ k, ds_c.transpose(-1, -2) @ q))
    for dq, dk in wrong:
        for i, grad in enumerate((dq, dk)):
            assert not _within(_merge(grad), want[..., i * hd:(i + 1) * hd])


@pytest.mark.parametrize("dh", [16, 32, 64])
def test_window_route_sends_bf16_to_the_tensor_cores(dh):
    """``window_route``: bf16 → the tensor-core kernels of rows 9 and 10 at
    every N the window kernels take, fp32 → the CUDA-core ones; N 0 and
    N 129, a head dim outside ``WINDOW_HEAD_DIMS`` (the window kernels keep
    their own rule; rows 1-7 take D >= 1) and fp16 refused."""
    assert dh in tfa.WINDOW_HEAD_DIMS and tfa.attention_head_dim_supported(dh)
    for n in range(1, tfa.MAX_WINDOW_TOKENS + 1):
        assert tfa.window_route(torch.bfloat16, n, dh) == "tensor_cores"
        assert tfa.window_route(torch.float32, n, dh) == "cuda_cores"
    for dtype, n, d in ((torch.bfloat16, 129, dh), (torch.float32, 129, dh),
                        (torch.bfloat16, 0, dh), (torch.float16, 49, dh),
                        (torch.bfloat16, 49, 24), (torch.float32, 49, 128)):
        with pytest.raises(ValueError):
            tfa.window_route(dtype, n, d)


@pytest.mark.parametrize("kernel", ["packed", "bwd", "batched", "fused_flat",
                                    "fused_slab"])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_window_route_names_each_kernel(dh, kernel):
    """``window_route(..., kernel)``: bf16 → the tensor cores for every
    window kernel, the slab one (row 13) too; fp32 → the CUDA cores; N 0 and
    N 129, fp16 and an unknown kernel refused; a head dim of 24 (not
    dividing 128) refused by the packed and fused kernels, whose JAX plans
    refuse it, and routed by the batched one and the backward, whose JAX
    plan admits it (bf16 the 32 tile, fp32 the chunks)."""
    for n in (1, 16, 17, 49, 64, 100, tfa.MAX_WINDOW_TOKENS):
        assert tfa.window_route(torch.bfloat16, n, dh, kernel) == "tensor_cores"
        assert tfa.window_route(torch.float32, n, dh, kernel) == "cuda_cores"
    refused = [(torch.bfloat16, 0, dh), (torch.bfloat16, 129, dh),
               (torch.float32, 129, dh), (torch.bfloat16, 49, 24),
               (torch.float16, 49, dh)]
    if kernel in tfa.WINDOW_ANY_HEAD_DIM_KERNELS:
        refused.remove((torch.bfloat16, 49, 24))
        assert tfa.window_route(torch.bfloat16, 49, 24, kernel) == \
            "tensor_cores_tile32"
        assert tfa.window_route(torch.float32, 49, 24, kernel) == \
            "cuda_cores_chunked"
    for dtype, n, d in refused:
        with pytest.raises(ValueError):
            tfa.window_route(dtype, n, d, kernel)
    with pytest.raises(ValueError, match="window kernels are"):
        tfa.window_route(torch.bfloat16, 49, dh, kernel + "_x")


def _wrong_window_orders(tqkv, bias, heads):
    """The two tempting wrong rounding orders of the window forward on a
    partitioned (G, N, 3·H·dh) bf16 qkv: q·scale rounded before the
    product; p rounded unnormalised with the division after P·V."""
    _, _, v, s = _window_scores(tqkv, bias, heads, q_scaled_bf16=True)
    q_rounded = _merge(torch.softmax(s, -1).to(torch.bfloat16).float() @ v)
    _, _, v, s = _window_scores(tqkv, bias, heads)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    divided_after = _merge((e.to(torch.bfloat16).float() @ v)
                           / e.sum(-1, keepdim=True))
    return q_rounded, divided_after


@pytest.mark.parametrize("g,heads,nwp", [(16, 3, 1), (8, 2, 8)])
def test_window_batched_reference_matches_jax_kernel_in_bf16(g, heads, nwp):
    """``window_attention_reference`` against ``_window_batched_kernel``
    (through ``_window_batched_fwd_pallas``), both in bf16 at N 49, dh 32,
    with the shared bias the router gives it and a per-window one; the two
    wrong rounding orders fail the same limits."""
    n, dh = 49, 32
    jqkv, tqkv, bias = _window_qkv(76, g, n, heads, dh, nwp)
    blk = jfa.window_batched_plan(g, n, heads, dh, nwp, 2)
    want = jfa._window_batched_fwd_pallas(jqkv, jnp.asarray(bias), heads,
                                          dh ** -0.5, blk)
    got = tfa.window_attention_reference(tqkv, torch.from_numpy(bias), heads)
    assert got.dtype == torch.bfloat16
    _close(got, want)
    for wrong in _wrong_window_orders(tqkv, bias, heads):
        assert not _within(wrong, want)


def test_window_fused_flat_reference_matches_jax_kernel_in_bf16():
    """``window_fused_reference`` against ``_window_fused_flat_kernel``
    (``fused_window_attention`` with ``window_fused_flat_plan``'s plan), both
    in bf16 on a shifted 14 x 14 map (window 7, shift 3, H 2, dh 32, nW' 4;
    batch 2, the least the JAX flat plan takes at 14 x 14: its images must
    fill whole 8-row DMA tiles). The JAX layout pads each section to 128
    lanes; the port's plain version takes the real H·dh. The two wrong
    rounding orders, applied on the rolled and partitioned map, fail the
    same limits."""
    b, hw, win, shift, heads, dh, nwp = 2, 14, 7, 3, 2, 32, 4
    hd, sec = heads * dh, 128
    real = _randn(78, b, hw, hw, 3, hd)
    padded = np.zeros((b, hw, hw, 3, sec), np.float32)
    padded[..., :hd] = real
    jmap, tmap = _pair(padded.reshape(b, hw, hw, 3 * sec))
    bias = _randn(79, nwp, heads, win * win, win * win)
    plan = jfa.window_fused_flat_plan(b, hw, hw, win, win, heads, dh, nwp, 2)
    assert plan is not None and plan[2] == "flat"
    want = _np(jfa.fused_window_attention(
        jmap, jnp.asarray(bias), heads, (win, win), (shift, shift), dh=dh,
        plan=plan))[..., :hd]
    got = tfa.window_fused_reference(tmap, torch.from_numpy(bias), heads,
                                     (win, win), (shift, shift), hd=hd)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hw, hw, sec)
    assert not got[..., hd:].float().any()
    _close(got[..., :hd], want)

    x = torch.from_numpy(real.reshape(b, hw, hw, 3 * hd)).to(torch.bfloat16)
    x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    x = x.reshape(b, 2, win, 2, win, 3 * hd).permute(0, 1, 3, 2, 4, 5)
    for wrong in _wrong_window_orders(x.reshape(-1, win * win, 3 * hd), bias,
                                      heads):
        o = wrong.reshape(b, 2, 2, win, win, hd).permute(0, 1, 3, 2, 4, 5)
        o = torch.roll(o.reshape(b, hw, hw, hd), shifts=(shift, shift),
                       dims=(1, 2))
        assert not _within(o, want)
