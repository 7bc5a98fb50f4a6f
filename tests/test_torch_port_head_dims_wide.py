"""Rows 1-7 above head dim 128 and the window rows 9-13 at dh 1, 2, 4 and 8,
against the JAX package.

The JAX kernels take any head dim, and its window plans every dh <= 64 that
divides 128. The port's CUDA kernels take the same (rows 1-7: D split across
the grid above 128, csrc/attention_wide_tile.cuh; rows 9-13: dh below 16 in
the 16 tile). On the CPU the port's wrappers run their plain versions, which
must compute the JAX package's function at those dims: inputs from a numpy
seed feed both packages, the JAX Pallas functions run in interpret mode (as
the JAX package's own tests run them), every JAX oracle is jitted.
Tolerances are fp32: |got − want| <= 1e-5 · max(1, max|want|) on attention
outputs and gradients (the two packages sum in different orders), 1e-4 on
model logits and gradients. Dropout is held at rate 0 (the packages' dropout
bits cannot be matched).

The narrow models: a ViT at dh 256 (hidden 512, 2 heads, 2 layers; ViT-B/16's
widths at 3 heads run on the card in chip_smoke.py) and a Swin at dh 8
(embed 32, 4 heads then 8, 2 stages; Swin-T's widths at 4× the heads run on
the card).

The kernels themselves are held against the plain versions in
tests/test_torch_port_kernels.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_windows import _jax_tpu_route, _port_route
from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu.models.image_classification import (
    swin_transformer as jswin,
)
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu.training import trainer as jtrainer
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformer,
    ViT,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.training import trainer as ttrainer
from vision_transformers_tpu_torch.utils.port_jax import (
    swin_state_dict_from_jax,
    vit_state_dict_from_jax,
)

ATOL = 1e-5
MODEL_ATOL = 1e-4
WIDE_DIMS = [160, 256]
NARROW_DIMS = [1, 2, 4, 8]


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(t, dtype=np.float32)


def _close(got, want, tol=ATOL):
    """|got - want| <= tol · max(1, max|want|), elementwise."""
    want = _np(want)
    assert _np(got).shape == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _leaf(a):
    return torch.from_numpy(a).requires_grad_()


# ---------------------------------------------------------------------------
# the rules


@pytest.mark.parametrize("d", [129, 160, 200, 256, 512, 1024])
def test_rows_1_to_7_take_head_dims_above_128(d):
    """Rows 1-7 admit every D >= 1 (the JAX kernels have no upper bound),
    and so does the fused block (row 8); the window kernels keep their own
    head dims."""
    assert tfa.attention_head_dim_supported(d)
    assert not tfa.attention_head_dim_supported(0)
    assert d not in tfa.WINDOW_HEAD_DIMS
    with pytest.raises(ValueError, match="head dim"):
        tfa.window_route(torch.bfloat16, 49, d)
    assert tfa.fused_block_supported(2 * d, 2)


def test_row_4_rule_is_the_shared_memory_bound():
    """Row 4's route is the JAX score budget alone, at every D: the largest
    square S it admits is 512 whatever D. The shared-memory bound
    (``flash_bwd_smem_bytes``, the fp32 resident kernel's footprint) now
    only chooses, inside the entry, between that kernel and the streaming
    passes: its largest square S still falls with D (160 at D 129, 64 at
    D 256, none from D 437 on)."""
    def largest(rule, d):
        return max([s for s in range(1, 600) if rule(s, d)] or [0])

    supported = lambda s, d: tfa.flash_bwd_supported(s, s, d)  # noqa: E731
    resident = lambda s, d: \
        tfa.flash_bwd_smem_bytes(s, s, d) <= tfa._SMEM_LIMIT  # noqa: E731
    dims = (129, 160, 200, 256, 436, 437, 512)
    assert [largest(supported, d) for d in dims] == [512] * len(dims)
    assert [largest(resident, d) for d in dims] == \
        [160, 128, 96, 64, 32, 0, 0]
    assert tfa.flash_bwd_smem_bytes(1, 1, 436) <= tfa._SMEM_LIMIT \
        < tfa.flash_bwd_smem_bytes(1, 1, 437)


@pytest.mark.parametrize("dh", NARROW_DIMS + [16, 32, 64])
def test_window_route_takes_the_jax_plans_head_dims(dh):
    """Every dh of the JAX window plans (<= 64, dividing 128) routes to the
    tensor cores in bf16 and the CUDA cores in fp32; the plans of both
    packages admit it; a row copies at ``window_grain`` bytes."""
    assert dh in tfa.WINDOW_HEAD_DIMS
    for kernel in tfa.WINDOW_KERNELS:
        assert tfa.window_route(torch.bfloat16, 49, dh, kernel) == \
            "tensor_cores"
        assert tfa.window_route(torch.float32, 49, dh, kernel) == "cuda_cores"
    assert tfa.window_grain(dh, 2) == min(16, 2 * dh)
    assert tfa.window_grain(dh, 4) == min(16, 4 * dh)
    assert tfa.window_pack_plan(32, 49, 3, dh, 1) is not None
    assert tfa.window_bwd_plan(32, 49, 3, dh) is not None
    assert tfa.window_fused_flat_plan(2, 28, 28, 7, 7, 3, dh, 1,
                                      2) is not None
    # the JAX plan packs 128/dh windows into a product: a count of windows
    # that fills the packs
    assert jfa.window_pack_plan(128, 16, 2, dh, 1) is not None


@pytest.mark.parametrize("dh", [3, 5, 12, 24, 96, 128])
def test_window_head_dims_outside_the_plans_still_raise(dh):
    """A window dh that does not divide 128, or is above 64: no pack or
    fused plan in either package, no packed route. The batched plans of
    both packages admit it (the JAX one has no head-dim term), and so do
    the port's batched and backward routes."""
    with pytest.raises(ValueError, match="head dim"):
        tfa.window_route(torch.bfloat16, 49, dh)
    for mod in (tfa, jfa):
        assert mod.window_pack_plan(32, 49, 3, dh, 1) is None
        assert mod.window_fused_flat_plan(2, 28, 28, 7, 7, 3, dh, 1,
                                          2) is None
        assert mod.window_batched_plan(32, 49, 3, dh, 1) is not None
    for kernel in ("batched", "bwd"):
        assert tfa.window_route(torch.bfloat16, 49, dh, kernel).startswith(
            "tensor_cores_")


@pytest.mark.parametrize("image,route", [(224, "packed"), (448, "split"),
                                         (576, "large")])
def test_vit_b16_at_3_heads_routes_as_the_jax_package(image, route):
    """ViT-B/16's widths at 3 heads (hidden 768, dh 256): both packages send
    224 px (S 197) to the packed kernel (row 1), 448 px (S 785) to the
    split-head one (row 2) and 576 px (S 1297) to the streaming one (row 3),
    by the same budgets (batch 32, 4 and 2), in bf16 and fp32."""
    s = (image // 16) ** 2 + 1
    b = {224: 32, 448: 4, 576: 2}[image]
    for itemsize in (2, 4):
        packed = tfa.packed_flash_supported(b, s, 3 * 768, itemsize)
        assert packed == jfa.packed_flash_supported(b, s, 3 * 768, itemsize)
        if itemsize == 2:
            assert packed == (route == "packed")
    large = s * s > tfa.MAX_SCORE_ELEMS
    assert tfa.MAX_SCORE_ELEMS == jfa._SMALL_S_LIMIT
    assert large == (route == "large")


# ---------------------------------------------------------------------------
# rows 1-7 above 128


@pytest.mark.parametrize("dh", WIDE_DIMS)
def test_wide_packed_forward_and_gradient_match_jax(dh):
    """Rows 1 and 7's plain versions against ``packed_flash_attention``
    (``_packed_fwd_kernel`` and ``_packed_bwd_kernel`` in interpret mode):
    out, lse, and dqkv by ``jax.vjp``, with trailing keys masked."""
    b, s, heads, kv_valid = 2, 11, 2, 9
    qkv = _randn(dh, b, s, 3 * heads * dh, scale=0.3)
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


@pytest.mark.parametrize("dh", WIDE_DIMS)
@pytest.mark.parametrize("route", ["small", "large"])
def test_wide_split_head_forward_matches_jax(route, dh, monkeypatch):
    """``flash_attention`` above D 128 through both forward routes: the
    small-S one (row 2's plain version against ``_attn_kernel`` in interpret
    mode, with a bias) and the streaming one (row 3's plain version against
    ``_large_kernel`` in interpret mode, through ``_flash_fwd_large`` with a
    key-padding mask), out and lse."""
    taken = []
    real = tfa.flash_attention_large_fwd
    monkeypatch.setattr(tfa, "flash_attention_large_fwd",
                        lambda *a, **kw: taken.append(1) or real(*a, **kw))
    b, h, sq, sk, kv_valid = 2, 2, 12, 10, 9
    q, k, v = (_randn(s_, b, h, n, dh, scale=0.3)
               for s_, n in ((60, sq), (61, sk), (62, sk)))
    g = b * h
    flat = lambda x: jnp.asarray(x.reshape(g, -1, dh))  # noqa: E731
    if route == "small":
        bias = _randn(63, 1, h, sq, sk)
        got, lse = tfa.flash_attention_fwd(
            *map(torch.from_numpy, (q, k, v, bias)), kv_valid=kv_valid)
        want, want_lse = jax.jit(
            lambda *a: jfa._flash_fwd(*a, None, dh ** -0.5, kv_valid, 256))(
            flat(q), flat(k), flat(v), jnp.asarray(bias[0]))
        assert taken == []
    else:
        mask = np.ones((b, sk), bool)
        mask[0, 3:5] = False
        mask[1, 6:] = False
        got, lse = tfa.flash_attention_fwd(
            *map(torch.from_numpy, (q, k, v)), kv_mask=torch.from_numpy(mask),
            kv_valid=kv_valid)
        want, want_lse = jax.jit(
            lambda *a: jfa._flash_fwd(*a, dh ** -0.5, kv_valid, 256))(
            flat(q), flat(k), flat(v), None, jnp.asarray(mask, jnp.int8))
        assert taken == [1]
    _close(_np(got).reshape(g, sq, dh), want)
    _close(_np(lse).reshape(g, sq), _np(want_lse).reshape(g, sq))


@pytest.mark.parametrize("dh", WIDE_DIMS)
@pytest.mark.parametrize("route", ["row 4", "row 6"])
def test_wide_bias_free_backward_matches_jax(route, dh, monkeypatch):
    """The bias-free backward of ``flash_attention`` above D 128 by both of
    its kernels: row 4 (``USE_PALLAS_BWD``; the shape inside the JAX score
    budget) against ``_flash_bwd_pallas`` in
    interpret mode, row 6 (the default) against ``jax.vjp`` of
    ``flash_dropout_attention`` at rate 0 (``_drop_bwd_kernel`` in interpret
    mode); kv_valid < Sk."""
    monkeypatch.setattr(tfa, "USE_PALLAS_BWD", route == "row 4")
    b, h, sq, sk, kv_valid = 1, 2, 13, 11, 9
    assert tfa.flash_bwd_supported(sq, sk, dh)
    q, k, v = (_randn(70 + i, b, h, n, dh, scale=0.3)
               for i, n in enumerate((sq, sk, sk)))
    do = _randn(73, b, h, sq, dh)
    leaves = [_leaf(a) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, kv_valid=kv_valid)
    out.backward(torch.from_numpy(do))
    if route == "row 4":
        _, lse = tfa.flash_attention_fwd(
            *map(torch.from_numpy, (q, k, v)), kv_valid=kv_valid)
        g = b * h
        flat = lambda x, s: jnp.asarray(_np(x).reshape(g, s, dh))  # noqa: E731
        want = jax.jit(lambda *a: jfa._flash_bwd_pallas(
            *a, dh ** -0.5, kv_valid))(
            flat(q, sq), flat(k, sk), flat(v, sk), flat(out, sq),
            jnp.asarray(_np(lse).reshape(g, sq, 1)), flat(do, sq))
        want = [_np(w).reshape(b, h, -1, dh) for w in want]
    else:
        def jvjp(q_, k_, v_, do_):
            _, vjp = jax.vjp(lambda *a: jfa.flash_dropout_attention(
                *a, dropout_rate=0.0, seed=jnp.zeros((1,), jnp.int32),
                kv_valid=kv_valid), q_, k_, v_)
            return vjp(do_)
        want = jax.jit(jvjp)(*map(jnp.asarray, (q, k, v, do)))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


def test_wide_dropout_mask_is_one_for_all_columns():
    """Rows 5 and 6's plain versions at D 256 and rate 0.3: each 128-column
    chunk of the output (and of dv) is the chunk of v (of do) under the one
    mask of (seed, group, row, column), the mask every chunk block of the
    kernels draws (the card tests hold the kernels to these plain
    versions)."""
    b, h, s, d = 1, 2, 9, 256
    q, k, v = (torch.from_numpy(_randn(80 + i, b, h, s, d, scale=0.3))
               for i in range(3))
    kw = dict(dropout_rate=0.3, seed=1234)
    out, lse = tfa.flash_dropout_attention_fwd(q, k, v, **kw)
    keep = tfa.dropout_keep_mask(1234, 0.3, b * h, s, s).view(b, h, s, s)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5, -1)
    drop = torch.where(keep, p / 0.7, torch.zeros_like(p))
    do = torch.from_numpy(_randn(90, b, h, s, d))
    _, _, dv = tfa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
    for c in range(2):
        cols = slice(128 * c, 128 * (c + 1))
        _close(out[..., cols], torch.matmul(drop, v[..., cols]))
        _close(dv[..., cols], torch.matmul(drop.transpose(-1, -2),
                                           do[..., cols]))


def test_narrow_vit_at_dh256_matches_jax():
    """A narrow ViT at dh 256 (hidden 512, 2 heads, MLP 512, 2 layers, patch
    16 at 32 px), the JAX params converted by ``vit_state_dict_from_jax``:
    logits and every parameter's gradient of a weighted sum of the logits
    (1e-4 × max(1, max|ref|))."""
    kw = dict(image_size=32, patch_size=16, num_layers=2, num_heads=2,
              hidden_dim=512, mlp_dim=512, num_classes=10)
    jmodel = JViT(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.RandomState(11)
    params = jax.tree.map(
        lambda s: (rng.randn(*s.shape) * (0.03 if len(s.shape) > 1 else 0.3)
                   ).astype(np.float32), shapes)
    x = _randn(12, 2, 32, 32, 3)
    w = _randn(13, 2, 10)

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
    _close(logits, want_logits, MODEL_ATOL)
    want = vit_state_dict_from_jax(jax.device_get(want_grads))
    named = dict(tmodel.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad, want[name], MODEL_ATOL)


# ---------------------------------------------------------------------------
# the window rows at dh 1, 2, 4 and 8


def _window_case(g, n, heads, dh, nwp, seed):
    qkv = _randn(seed, g, n, 3 * heads * dh, scale=0.5)
    bias = None if nwp == 0 else _randn(seed + 1, nwp, heads, n, n, scale=0.5)
    return qkv, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jax_packed(qkv, bias, heads):
    """The JAX package's packed window attention: the Pallas kernel in
    interpret mode where its plan packs the windows (G a multiple of
    128/dh: dh 4 and 8 here), its jnp twin ``_window_pack_ref`` where the
    plan refuses (dh 1 and 2 need 128 and 64 windows a pack)."""
    g, n, three_hd = qkv.shape
    dh = three_hd // (3 * heads)
    nwp = 1 if bias is None else bias.shape[0]
    if jfa.window_pack_plan(g, n, heads, dh, nwp) is not None:
        return jfa.window_packed_attention(qkv, bias, heads)
    return jfa._window_pack_ref(qkv, bias, heads, dh ** -0.5)


@pytest.mark.parametrize("dh", NARROW_DIMS)
@pytest.mark.parametrize("kind,nwp", [("packed", 4), ("batched", 1)])
def test_narrow_window_forward_matches_jax(kind, nwp, dh):
    """The packed (row 9, per-window bias) and batched (row 11, shared bias)
    wrappers against the JAX functions (``_jax_packed``; the batched kernel
    in interpret mode, whose plan takes every dh)."""
    g, n, heads = 32, 16, 3
    qkv, bias = _window_case(g, n, heads, dh, nwp, 10 + dh)
    if kind == "packed":
        want = _highest(_jax_packed, jnp.asarray(qkv), _j(bias), heads)
        got = tfa.window_packed_attention(_t(qkv), _t(bias), heads)
    else:
        assert jfa.window_batched_plan(g, n, heads, dh, nwp) is not None
        want = _highest(jfa.window_batched_attention, jnp.asarray(qkv),
                        _j(bias), heads)
        got = tfa.window_batched_attention(_t(qkv), _t(bias), heads)
    assert got.shape == (g, n, heads * dh)
    _close(got, want)


@pytest.mark.parametrize("dh", NARROW_DIMS)
@pytest.mark.parametrize("kind", ["slab", "flat"])
def test_narrow_fused_window_matches_jax(kind, dh):
    """The fused wrapper's slab (row 13) and flat (row 12) plans against
    ``fused_window_attention`` on a shifted map with a per-window bias; the
    port's map is unpadded (sec = H·dh), the JAX one padded to its 128
    lanes, the same values."""
    heads, win, shift = 4, (4, 4), (2, 2)
    b, hp, wp = (2, 8, 8) if kind == "slab" else (2, 12, 12)
    hd = heads * dh
    n, nwin = 16, (hp // 4) * (wp // 4)
    real = _randn(20 + dh, b, hp, wp, 3, hd, scale=0.5)
    bias = _randn(30 + dh, nwin, heads, n, n, scale=0.5)
    jmap = np.zeros((b, hp, wp, 3, 128), np.float32)
    jmap[..., :hd] = real
    jplan_fn = (jfa.window_fused_plan if kind == "slab"
                else jfa.window_fused_flat_plan)
    tplan_fn = (tfa.window_fused_plan if kind == "slab"
                else tfa.window_fused_flat_plan)
    jplan = jplan_fn(b, hp, wp, *win, heads, dh, nwin, 4)
    tplan = tplan_fn(b, hp, wp, *win, heads, dh, nwin, 4)
    assert tplan is not None and tplan[0] == kind
    jmap = jnp.asarray(jmap.reshape(b, hp, wp, 384))
    if jplan is not None:  # dh 4, 8: packs of 32, 16 windows fill the map
        want = _highest(jfa.fused_window_attention, jmap, jnp.asarray(bias),
                        heads, win, shift, dh=dh, plan=jplan)
    else:  # packs of 128 or 64 windows: the JAX package's jnp twin
        want = _highest(jfa._window_fused_ref, jmap, jnp.asarray(bias),
                        heads, win, shift, dh ** -0.5, hd=hd)
    got = tfa.fused_window_attention(
        torch.from_numpy(np.ascontiguousarray(real.reshape(b, hp, wp,
                                                           3 * hd))),
        torch.from_numpy(bias), heads, win, shift, dh=dh, plan=tplan)
    assert got.shape == (b, hp, wp, hd)
    _close(got, _np(want)[..., :hd])


@pytest.mark.parametrize("dh", NARROW_DIMS)
def test_narrow_window_backward_matches_jax_grad(dh):
    """Row 10's plain version (the backward the window wrappers share)
    against ``jax.grad`` through ``_jax_packed`` (the Pallas backward in
    interpret mode at dh 4 and 8): dqkv and the bias gradient (per-window
    bias)."""
    g, n, heads, nwp = 32, 16, 2, 4
    qkv, bias = _window_case(g, n, heads, dh, nwp, 40 + dh)
    do = _randn(50 + dh, g, n, heads * dh)
    cot = jnp.asarray(do)

    def jloss(q, b_):
        return jnp.sum(_jax_packed(q, b_, heads) * cot)

    want_q, want_b = _highest(jax.jit(jax.grad(jloss, (0, 1))),
                              jnp.asarray(qkv), jnp.asarray(bias))
    tq, tb = _leaf(qkv), _leaf(bias)
    out = tfa.window_packed_attention(tq, tb, heads)
    out.backward(torch.from_numpy(do))
    _close(tq.grad, want_q)
    _close(tb.grad, want_b)


def test_swin_t_at_4x_heads_routes_as_the_jax_package(monkeypatch):
    """Swin-T's widths at 4× its heads (dh 8, [12, 24, 48, 96]) at batch 32:
    every block takes the route the JAX package takes on a TPU, traced with
    shapes only. They differ from Swin-T's own (dh 32) where the JAX plans'
    VMEM budgets refuse: stage 2's shifted block takes the packed kernel,
    stage 3 the split-head path."""
    size, win = 56, (7, 7)
    routes = []
    for stage, (depth, heads) in enumerate(zip((2, 2, 6, 2),
                                               (12, 24, 48, 96))):
        c = 96 * 2 ** stage
        for layer in range(depth):
            shift = (0, 0) if layer % 2 == 0 else (3, 3)
            want = _jax_tpu_route(monkeypatch, 32, size, c, heads, win,
                                  shift, False)
            got = _port_route(monkeypatch, 32, size, c, heads, win, shift,
                              False)
            assert got == want, (stage, layer)
            routes.append(got)
        size = -(-size // 2)
    assert routes == ["batched", "fused_slab", "batched", "pack"] \
        + ["split"] * 6 + ["batched", "batched"]


NARROW_SWIN = dict(patch_size=[2, 2], embed_dim=32, depths=[2, 2],
                   num_heads=[4, 8], window_size=[4, 4], num_classes=10,
                   stochastic_depth_prob=0.0)


def test_narrow_swin_at_dh8_matches_jax():
    """A narrow Swin at dh 8 (embed 32, 4 heads then 8, 2 stages, window 4
    at 20 px): the loss and every parameter's gradient against the JAX
    model's in training mode (stochastic depth 0), the weights converted by
    ``swin_state_dict_from_jax``."""
    jmodel = jswin.SwinTransformer(**NARROW_SWIN)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 20, 20, 3)))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda a: (rng.randn(*a.shape) * (0.1 if len(a.shape) > 1 else 0.3)
                   + (len(a.shape) == 1)).astype(np.float32), shapes)
    x = _randn(4, 4, 20, 20, 3)
    y = np.random.RandomState(5).randint(0, 10, 4).astype(np.int32)
    w = np.ones(4, np.float32)

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              deterministic=False)
        return jtrainer.cross_entropy_with_weights(
            logits, jnp.asarray(y), jnp.asarray(w)), logits

    (want_loss, want_logits), want = _highest(
        jax.jit(jax.value_and_grad(loss, has_aux=True)), params)
    want = swin_state_dict_from_jax(jax.device_get(want))
    tmodel = SwinTransformer(**NARROW_SWIN, device="cpu")
    tmodel.load_state_dict(swin_state_dict_from_jax(params), strict=True)
    tmodel.train()
    logits = tmodel(torch.from_numpy(x))
    got_loss = ttrainer.cross_entropy_with_weights(
        logits, torch.from_numpy(y).long(), torch.from_numpy(w))
    got_loss.backward()
    _close(logits, want_logits, MODEL_ATOL)
    assert abs(got_loss.item() - float(want_loss)) <= MODEL_ATOL
    names = dict(tmodel.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        _close(p.grad, want[name], MODEL_ATOL)
    assert float(names["stage0_block1.attn.relative_position_bias_table"]
                 .grad.abs().max()) > 1e-6  # dbias arrives
