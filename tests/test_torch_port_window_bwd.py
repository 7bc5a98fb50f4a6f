"""The port's window-attention backward against the JAX package.

Inputs come from a numpy seed and feed both packages. On the CPU the port's
``window_attention_bwd`` takes its plain version
(``window_attention_bwd_reference``), and the four window wrappers reach it
through their autograd functions. The JAX side is ``jax.grad`` through
``window_packed_attention``, ``window_batched_attention`` and
``fused_window_attention`` called directly: off-TPU their backward rule runs
``_window_pack_bwd_pallas`` in interpret mode where ``_window_pack_bwd_gblk``
has a plan (``g % (128 // dh) == 0``) and the jnp recompute of the reference
otherwise; each case says which one it expects to have run. JAX runs under
the highest matmul precision.

Tolerances. fp32: 1e-5 absolute on gradients of O(1) (summation order;
every route of ``shifted_window_attention`` 1e-4; whole models are in
``tests/test_torch_port_swin_train.py``). bf16: both
packages round the bias, the probabilities and ds·scale to bf16 at the same
places but sum in different orders, so a gradient may differ by a couple of
bf16 ulps of the largest element: 2e-2·max(1, max|ref|), the tolerance the
kernel is held to on the card. dbias sums G/nW' windows and is held relative
to its own scale in the same way.

The CUDA kernel itself is held against the plain version in
``tests/test_torch_port_kernels.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_windows as W
import vision_transformers_tpu.ops.windows as JW
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import windows as TW

ATOL = 1e-5
MODEL_ATOL = 1e-4
BF16_REL = 2e-2

_randn, _np, _highest = W._randn, W._np, W._highest


def _close(got, want, dtype="float32", atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        atol = BF16_REL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _jax_grads(fn, jq, jb, do):
    """Gradients of sum(fn(qkv, bias) · do) in qkv and (if any) the bias."""
    cot = jnp.asarray(do, jnp.float32)

    def loss(q, b):
        return jnp.sum(fn(q, b).astype(jnp.float32) * cot)

    if jb is None:
        return (_highest(jax.grad(lambda q: loss(q, None)), jq), None)
    return _highest(jax.grad(loss, (0, 1)), jq, jb)


def _torch_grads(fn, tq, tb, do):
    tq = tq.clone().requires_grad_()
    tb = None if tb is None else tb.clone().requires_grad_()
    out = fn(tq, tb)
    leaves = [tq] if tb is None else [tq, tb]
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(out.dtype))
    return grads[0], (None if tb is None else grads[1])


_BWD_CASES = [
    # g, n, heads, dh, nW', what the JAX backward rule runs off-TPU
    (8, 16, 2, 32, 0, "pallas"),    # no bias
    (8, 16, 2, 32, 1, "pallas"),    # shared bias
    (8, 16, 2, 32, 4, "pallas"),    # per-window bias dividing the pack
    (36, 9, 1, 32, 9, "pallas"),    # nW' = 9 against packs of 4 (lcm 36)
    (8, 16, 2, 16, 1, "pallas"),    # dh 16: packs of 8
    (4, 16, 1, 64, 2, "pallas"),    # dh 64: packs of 2
    (6, 16, 2, 32, 3, "jnp"),       # g % 4 != 0: JAX recomputes in jnp
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,heads,dh,nwp,jax_branch", _BWD_CASES)
def test_window_backward_matches_jax_grad(dtype, g, n, heads, dh, nwp,
                                          jax_branch):
    """``window_attention_bwd`` (its plain version here), and autograd through
    the packed and batched wrappers, against ``jax.grad`` through the JAX
    package's packed function: dqkv and dbias."""
    qkv, bias = W._qkv_bias(g, n, heads, dh, nwp, seed=60)
    do = _randn(62, g, n, heads * dh, scale=0.5)
    (jq, jb), (tq, tb) = W._both(qkv, bias, dtype)
    itemsize = 4 if dtype == "float32" else 2
    gblk = jfa._window_pack_bwd_gblk(g, n, heads, dh, max(nwp, 1), itemsize)
    assert (gblk is not None) == (jax_branch == "pallas")
    if jax_branch == "pallas":
        jfn = lambda q, b: jfa.window_packed_attention(q, b, heads)  # noqa: E731
    else:  # no TPU plan for the forward either: the rule's own jnp branch
        assert jfa.window_pack_plan(g, n, heads, dh, max(nwp, 1)) is None
        jfn = lambda q, b: jfa._window_pack_ref(  # noqa: E731
            q, None if b is None else b.astype(q.dtype), heads, dh ** -0.5)
    want_q, want_b = _jax_grads(jfn, jq, jb, do)

    got_q, got_b = tfa.window_attention_bwd(
        tq, tb, torch.from_numpy(do).to(tq.dtype), heads)
    assert got_q.dtype == tq.dtype and got_q.shape == tq.shape
    _close(got_q, want_q, dtype)
    if nwp:
        assert got_b.dtype == torch.float32 and got_b.shape == tb.shape
        _close(got_b, want_b, dtype)
        lean, none = tfa.window_attention_bwd(
            tq, tb, torch.from_numpy(do).to(tq.dtype), heads, need_dbias=False)
        assert none is None and torch.equal(lean, got_q)
    else:
        assert got_b is None
    for wrapper in (tfa.window_packed_attention, tfa.window_batched_attention):
        auto_q, auto_b = _torch_grads(lambda q, b: wrapper(q, b, heads),
                                      tq, tb, do)
        assert torch.equal(auto_q, got_q)  # the wrappers' backward is this
        assert nwp == 0 or torch.equal(auto_b, got_b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,heads,dh,nwp", [(8, 16, 2, 32, 0),
                                              (8, 16, 2, 32, 1),
                                              (16, 16, 2, 16, 8)])
def test_window_batched_backward_matches_jax_grad(dtype, g, n, heads, dh, nwp):
    qkv, bias = W._qkv_bias(g, n, heads, dh, nwp, seed=63)
    do = _randn(64, g, n, heads * dh, scale=0.5)
    (jq, jb), (tq, tb) = W._both(qkv, bias, dtype)
    assert jfa.window_batched_plan(g, n, heads, dh, max(nwp, 1)) is not None
    assert jfa._window_pack_bwd_gblk(g, n, heads, dh, max(nwp, 1)) is not None
    want = _jax_grads(lambda q, b: jfa.window_batched_attention(q, b, heads),
                      jq, jb, do)
    got = _torch_grads(lambda q, b: tfa.window_batched_attention(q, b, heads),
                       tq, tb, do)
    for a, r in zip(got, want):
        if r is not None:
            _close(a, r, dtype)


def test_backward_reference_equals_autograd_of_the_forward_reference():
    """The two oracles of the kernel agree to fp32 round-off, masks of -100
    and -1e9 inside the bias included."""
    g, n, heads, dh, nwp = 8, 16, 2, 32, 4
    qkv, bias = W._qkv_bias(g, n, heads, dh, nwp, seed=65)
    bias[1, :, :, 12:] = -100.0
    bias[2, :, :, 9:] += -1e9
    do = _randn(66, g, n, heads * dh)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    want = _torch_grads(
        lambda q, b: tfa.window_attention_reference(q, b, heads), tq, tb, do)
    got = tfa.window_attention_bwd_reference(tq, tb, torch.from_numpy(do),
                                             heads)
    for a, r in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _close(a, r)


def test_bf16_backward_reads_the_rounded_bias():
    """The gradient is the one of the forward that ran: with a bias that bf16
    rounds visibly, the backward equals the one from the pre-rounded bias."""
    g, n, heads, dh = 4, 16, 2, 32
    qkv, bias = W._qkv_bias(g, n, heads, dh, 1, seed=67)
    bias = bias * 3.0 + 0.001
    do = torch.from_numpy(_randn(68, g, n, heads * dh)).bfloat16()
    tq = torch.from_numpy(qkv).bfloat16()
    tb = torch.from_numpy(bias)
    a = tfa.window_attention_bwd(tq, tb, do, heads)
    b = tfa.window_attention_bwd(tq, tb.bfloat16().float(), do, heads)
    assert not torch.equal(tb, tb.bfloat16().float())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].dtype == torch.float32


def _fused_grad_case(kind, dtype, shift, per_window, heads=4, dh=32,
                     pad_to=None):
    win = (4, 4)
    b, hp, wp = (2, 8, 8) if kind == "slab" else (4, 12, 12)
    hd = heads * dh
    sec = hd if pad_to is None else pad_to
    n, nwin = 16, (hp // 4) * (wp // 4)
    nwp = nwin if per_window else 1
    qkv_map = np.zeros((b, hp, wp, 3, sec), np.float32)
    qkv_map[..., :hd] = _randn(70, b, hp, wp, 3, hd, scale=0.5)
    qkv_map = qkv_map.reshape(b, hp, wp, 3 * sec)
    bias = _randn(71, nwp, heads, n, n, scale=0.5)
    do = _randn(72, b, hp, wp, sec, scale=0.5)
    itemsize = 4 if dtype == "float32" else 2
    plan_fn = "window_fused_plan" if kind == "slab" else "window_fused_flat_plan"
    jplan = getattr(jfa, plan_fn)(b, hp, wp, *win, heads, dh, nwp, itemsize)
    tplan = getattr(tfa, plan_fn)(b, hp, wp, *win, heads, dh, nwp, itemsize)
    assert jplan is not None and tplan is not None and tplan[0] == kind
    # the JAX rule differentiates the layout chain around the Pallas core
    g = b * nwin
    assert jfa.window_pack_plan(g, n, heads, dh, nwp, itemsize) is not None
    assert jfa._window_pack_bwd_gblk(g, n, heads, dh, nwp, itemsize) is not None
    (jq, jb), (tq, tb) = W._both(qkv_map, bias, dtype)
    want = _jax_grads(lambda q, bb: jfa.fused_window_attention(
        q, bb, heads, win, shift, dh=dh, plan=jplan), jq, jb, do)
    got = _torch_grads(lambda q, bb: tfa.fused_window_attention(
        q, bb, heads, win, shift, dh=dh, plan=tplan), tq, tb, do)
    return got, want


@pytest.mark.parametrize("kind", ["slab", "flat"])
@pytest.mark.parametrize("dtype,shift,per_window", [
    ("float32", (0, 0), False), ("float32", (2, 2), True),
    ("float32", (1, 3), True), ("bfloat16", (2, 2), True)])
def test_fused_window_backward_matches_jax_grad(dtype, kind, shift,
                                                per_window):
    got, want = _fused_grad_case(kind, dtype, shift, per_window)
    for a, r in zip(got, want):
        _close(a, r, dtype)


@pytest.mark.parametrize("kind", ["slab", "flat"])
def test_fused_window_backward_zeroes_the_pad_lanes(kind):
    """Sections padded to 128 lanes (the JAX layout): the map's gradient
    equals JAX's and is zero in the pad lanes."""
    got, want = _fused_grad_case(kind, "float32", (2, 2), True, heads=2,
                                 dh=32, pad_to=128)
    for a, r in zip(got, want):
        _close(a, r)
    dmap = _np(got[0])
    pads = dmap.reshape(*dmap.shape[:3], 3, 128)[..., 64:]
    assert not pads.any()


def test_fused_window_out_takes_no_gradient():
    qmap = torch.zeros(1, 8, 8, 3 * 32, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        tfa.fused_window_attention(qmap, None, 2, (4, 4), (0, 0),
                                   out=torch.empty(1, 8, 8, 32))


def test_backward_plan_covers_what_the_forward_plans_cover():
    """Every (N, dh) a forward plan accepts has a backward plan whose block
    fits the card's shared memory; none of the TPU's ``g % p`` conditions.
    The batched plan admits dh 96 (its JAX plan has no head-dim term), so
    the backward plan does too; N 144 has none."""
    for n in (1, 9, 16, 49, 64, 100, 128):
        for dh in (16, 32, 64):
            for g in (1, 3, 2048):
                assert tfa.window_pack_plan(g, n, 3, dh, 1) is not None
                p, threads = tfa.window_bwd_plan(g, n, 3, dh)
                assert p >= 1 and p * n <= threads <= 256 and threads % 32 == 0
                assert tfa._window_bwd_smem(p, n, dh) <= 232448
    assert tfa.window_bwd_plan(8, 49, 3, 32) == (3, 160)  # Swin-T
    assert tfa.window_bwd_plan(8, 64, 3, 32) == (2, 128)  # SwinV2-T
    assert tfa.window_bwd_plan(8, 144, 3, 32) is None
    assert tfa.window_batched_plan(8, 49, 3, 96, 1) is not None
    assert tfa.window_bwd_plan(8, 49, 3, 96) == (3, 160)  # 32-column chunks
    with pytest.raises(ValueError, match="do must be"):
        tfa.window_attention_bwd(torch.zeros(2, 4, 3 * 32), None,
                                 torch.zeros(2, 4, 16), 1)


# ---------------------------------------------------------------------------
# shifted_window_attention in training mode, every route, both packages


def _swa_grads(mod, conv, inp, route, heads, win, shift, logit_scale,
               mask_padding, cot):
    """Gradients of sum(out · cot) in x and every parameter of the call."""
    names = [k for k, v in inp.items() if v is not None]
    if logit_scale is not None:
        names.append("logit_scale")
    values = dict(inp, logit_scale=logit_scale)

    def run(*arrays):
        local = dict(values, **dict(zip(names, arrays)))
        ls = local.pop("logit_scale")
        fused, pack, batched = W._ROUTES[route]
        old = (mod.FORCE_FUSED_WINDOW, mod.FORCE_PACK_PATH,
               mod.FORCE_BATCHED_WINDOW)
        mod.FORCE_FUSED_WINDOW, mod.FORCE_PACK_PATH = fused, pack
        mod.FORCE_BATCHED_WINDOW = batched
        try:
            return mod.shifted_window_attention(
                local["x"], local["qkv_k"], local["qkv_b"], local["proj_k"],
                local["proj_b"], local["rel"], window_size=win,
                num_heads=heads, shift_size=shift, logit_scale=ls,
                mask_padding=mask_padding, deterministic=False)
        finally:
            (mod.FORCE_FUSED_WINDOW, mod.FORCE_PACK_PATH,
             mod.FORCE_BATCHED_WINDOW) = old

    arrays = [conv(values[k]) for k in names]
    if mod is JW:
        loss = lambda *a: jnp.sum(run(*a) * jnp.asarray(cot))  # noqa: E731
        grads = _highest(jax.grad(loss, tuple(range(len(arrays)))), *arrays)
    else:
        arrays = [a.requires_grad_() for a in arrays]
        grads = torch.autograd.grad(run(*arrays), arrays,
                                    torch.from_numpy(cot))
    return dict(zip(names, grads))


_SWA_GRAD_CASES = [
    # (label, hw, win, shift, cosine, mask_padding)
    ("no shift", (8, 8), (4, 4), (0, 0), False, False),
    ("shifted", (8, 8), (4, 4), (2, 2), False, False),
    ("cosine shifted", (8, 8), (4, 4), (2, 2), True, False),
    ("pad mask", (7, 7), (4, 4), (0, 0), False, True),
    ("cosine padded map", (7, 6), (4, 4), (2, 2), True, False),
]


@pytest.mark.parametrize("route", list(W._ROUTES))
@pytest.mark.parametrize("label,hw,win,shift,cosine,mask_padding",
                         _SWA_GRAD_CASES, ids=[c[0] for c in _SWA_GRAD_CASES])
def test_shifted_window_attention_gradients_match_jax(
        route, label, hw, win, shift, cosine, mask_padding):
    """Training mode (``deterministic=False``, attention dropout 0): the
    gradient with respect to x, the kernels, the biases, the relative
    position bias and SwinV2's ``logit_scale``, on every route. A map padded
    to window multiples has exact-zero rows, which the cosine normalisation
    must survive (x·rsqrt(Σx² + 1e-12))."""
    geo = W._GEOM[route]
    heads = geo["heads"]
    inp = W._swa_inputs(geo["b"], hw, heads * geo["c_per_head"], heads, win,
                        seed=80, qkv_bias=not cosine)
    ls = np.full((heads, 1, 1), np.log(10.0), np.float32) + \
        _randn(81, heads, 1, 1, scale=0.3) if cosine else None
    cot = _randn(82, *inp["x"].shape)
    want = _swa_grads(JW, W._jconv, inp, route, heads, win, shift, ls,
                      mask_padding, cot)
    TW.ROUTE_LOG = []
    try:
        got = _swa_grads(TW, W._tconv, inp, route, heads, win, shift, ls,
                         mask_padding, cot)
        assert len(TW.ROUTE_LOG) == 1 and TW.ROUTE_LOG[0].startswith(route)
    finally:
        TW.ROUTE_LOG = None
    assert set(got) == set(want) and "rel" in got
    for name in want:
        assert bool(torch.isfinite(got[name]).all()), name
        _close(got[name], want[name], atol=MODEL_ATOL)


def test_static_masks_are_constants_of_the_graph():
    """The cached shift/pad mask takes no gradient and is not written to: two
    backward passes through one geometry leave it as it was."""
    heads, win = 2, (4, 4)
    inp = W._swa_inputs(2, (7, 7), heads * 16, heads, win, seed=83)
    mask = TW._static_mask(8, 8, 7, 7, 4, 4, 2, 2, True, torch.device("cpu"))
    before = mask.clone()
    for _ in range(2):
        x = torch.from_numpy(inp["x"]).requires_grad_()
        rel = torch.from_numpy(inp["rel"]).requires_grad_()
        out = TW.shifted_window_attention(
            x, W._tconv(inp["qkv_k"]), W._tconv(inp["qkv_b"]),
            W._tconv(inp["proj_k"]), W._tconv(inp["proj_b"]), rel,
            window_size=win, num_heads=heads, shift_size=(2, 2),
            mask_padding=True, deterministic=False)
        out.sum().backward()
        assert rel.grad is not None and x.grad is not None
    again = TW._static_mask(8, 8, 7, 7, 4, 4, 2, 2, True, torch.device("cpu"))
    assert again is mask and not mask.requires_grad
    assert torch.equal(mask, before)


def test_dropout_route_differentiates_with_a_bias():
    """attention_dropout > 0 in training leaves the window kernels for the
    split-head path with bias and dropout (plain math in both packages):
    differentiable, and at rate → 0 it meets the kernel routes' gradient."""
    heads, win = 2, (4, 4)
    inp = W._swa_inputs(2, (8, 8), heads * 8, heads, win, seed=84)
    TW._pack_dropout_warned = True

    def grads(rate):
        x = torch.from_numpy(inp["x"]).requires_grad_()
        rel = torch.from_numpy(inp["rel"]).requires_grad_()
        TW.ROUTE_LOG = []
        try:
            out = TW.shifted_window_attention(
                x, W._tconv(inp["qkv_k"]), W._tconv(inp["qkv_b"]),
                W._tconv(inp["proj_k"]), W._tconv(inp["proj_b"]), rel,
                window_size=win, num_heads=heads, shift_size=(2, 2),
                attention_dropout=rate, deterministic=False,
                generator=torch.Generator().manual_seed(1))
            route = TW.ROUTE_LOG[0]
        finally:
            TW.ROUTE_LOG = None
        return route, torch.autograd.grad(out.square().sum(), (x, rel))

    route, dropped = grads(0.3)
    assert route == "split"
    assert all(bool(torch.isfinite(g).all()) and bool(g.any())
               for g in dropped)
    route0, tiny = grads(1e-9)   # still the dropout path, nothing dropped
    kernel_route, exact = grads(0.0)
    assert route0 == "split" and kernel_route.startswith("fused")
    for a, r in zip(tiny, exact):
        _close(a, r)
