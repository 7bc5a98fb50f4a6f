"""The PyTorch port's windowed attention against the JAX package.

Inputs come from a numpy seed and feed both packages. On the CPU the port's
four window wrappers take their plain PyTorch versions; the JAX Pallas
functions run in interpret mode at tiny shapes, reached directly or through
the ``FORCE_*`` hooks of ``ops/windows.py``, as ``tests/test_windows.py``
reaches them. JAX runs under the highest matmul precision (its CPU default
may round fp32 matmul inputs).

Tolerances: fp32 1e-5 absolute on outputs of O(1) (summation order). bf16:
both packages round the bias to bf16 and the normalised probabilities to
bf16 before PV, but sum in different orders, so outputs of magnitude <= 2
may differ by two bf16 ulps there (2 · 2^-7).

The CUDA kernels themselves are held against the plain versions in
``tests/test_torch_port_kernels.py``, on the card.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_transformers_tpu.ops.windows as JW
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu.utils.args import get_args as jget_args
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import windows as TW
from vision_transformers_tpu_torch.utils.args import get_args

ATOL = 1e-5
ATOL_BF16 = 2 * 2.0 ** -7


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


# ---------------------------------------------------------------------------
# static helpers: own numpy copies must equal the JAX package's


@pytest.mark.parametrize("wh,ww", [(4, 4), (7, 7), (2, 3), (1, 5)])
def test_static_tables_match_jax(wh, ww):
    np.testing.assert_array_equal(TW.relative_position_index(wh, ww),
                                  JW.relative_position_index(wh, ww))
    np.testing.assert_array_equal(TW.relative_coords_table(wh, ww),
                                  JW.relative_coords_table(wh, ww))


@pytest.mark.parametrize("pad_h,pad_w,window,shift", [
    (8, 8, (4, 4), (2, 2)), (8, 8, (4, 4), (0, 0)), (28, 28, (7, 7), (3, 3)),
    (8, 12, (4, 4), (2, 0)), (12, 8, (4, 2), (1, 1))])
def test_shift_mask_matches_jax(pad_h, pad_w, window, shift):
    got = TW.shift_attn_mask(pad_h, pad_w, window, shift)
    want = JW.shift_attn_mask(pad_h, pad_w, window, shift)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {0.0, -100.0}


@pytest.mark.parametrize("pad_h,pad_w,h,w,window", [
    (8, 8, 7, 7, (4, 4)), (8, 8, 8, 8, (4, 4)), (28, 28, 27, 25, (7, 7))])
def test_edge_pad_mask_matches_jax(pad_h, pad_w, h, w, window):
    got = TW.edge_pad_key_mask(pad_h, pad_w, h, w, window)
    want = JW.edge_pad_key_mask(pad_h, pad_w, h, w, window)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {0.0, np.float32(-1e9)}


def test_window_partition_reverse_match_jax():
    x = _randn(0, 2, 8, 12, 5)
    got = TW.window_partition(torch.from_numpy(x), 4, 4)
    want = JW.window_partition(jnp.asarray(x), 4, 4)
    assert got.shape == (2 * 2 * 3, 16, 5)
    np.testing.assert_array_equal(_np(got), _np(want))
    back = TW.window_reverse(got, 4, 4, 8, 12)
    np.testing.assert_array_equal(_np(back), x)


# ---------------------------------------------------------------------------
# the four wrappers against their JAX functions (Pallas, interpret mode)


def _qkv_bias(g, n, heads, dh, nwp, seed=0):
    qkv = _randn(seed, g, n, 3 * heads * dh, scale=0.5)
    bias = None if nwp == 0 else _randn(seed + 1, nwp, heads, n, n, scale=0.5)
    return qkv, bias


def _compare(got, want, dtype):
    tol = ATOL if dtype == "float32" else ATOL_BF16
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def _both(qkv, bias, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    return (jnp.asarray(qkv, jdt), jb), (torch.from_numpy(qkv).to(tdt), tb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,heads,dh,nwp", [
    (8, 16, 2, 32, 0),      # no bias
    (8, 16, 2, 32, 1),      # shared bias
    (8, 16, 2, 32, 4),      # per-window bias dividing the pack
    (12, 16, 1, 32, 3),     # nW' = 3 against packs of 4: the modulo case
    (196, 9, 1, 32, 49),    # SwinV2-T stage 1: nW' = 49, dh 32, packs of 4
    (16, 49, 3, 32, 1),     # Swin-T window and heads
])
def test_window_packed_matches_jax(dtype, g, n, heads, dh, nwp):
    qkv, bias = _qkv_bias(g, n, heads, dh, nwp)
    (jq, jb), (tq, tb) = _both(qkv, bias, dtype)
    assert jfa.window_pack_plan(g, n, heads, dh, max(nwp, 1)) is not None
    want = _highest(jfa.window_packed_attention, jq, jb, heads)
    got = tfa.window_packed_attention(tq, tb, heads)
    assert got.shape == (g, n, heads * dh) and got.dtype == tq.dtype
    _compare(got, want, dtype)


@pytest.mark.parametrize("g,nwp", [(6, 3), (5, 1), (7, 0), (14, 7)])
def test_window_packed_takes_counts_the_tpu_plan_refuses(g, nwp):
    """G need not be a multiple of the TPU's pack width: the JAX plan is
    None there, so the port is held against the JAX plain reference."""
    n, heads, dh = 16, 2, 32
    qkv, bias = _qkv_bias(g, n, heads, dh, nwp, seed=3)
    assert jfa.window_pack_plan(g, n, heads, dh, max(nwp, 1)) is None
    assert tfa.window_pack_plan(g, n, heads, dh, max(nwp, 1)) is not None
    want = _highest(jfa._window_pack_ref, jnp.asarray(qkv),
                    None if bias is None else jnp.asarray(bias), heads,
                    dh ** -0.5)
    got = tfa.window_packed_attention(
        torch.from_numpy(qkv), None if bias is None else torch.from_numpy(bias),
        heads)
    _compare(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,heads,dh,nwp", [
    (8, 16, 2, 32, 0), (8, 16, 2, 32, 1), (16, 16, 2, 16, 8),
    (8, 49, 3, 32, 1)])
def test_window_batched_matches_jax(dtype, g, n, heads, dh, nwp):
    qkv, bias = _qkv_bias(g, n, heads, dh, nwp, seed=5)
    (jq, jb), (tq, tb) = _both(qkv, bias, dtype)
    assert jfa.window_batched_plan(g, n, heads, dh, max(nwp, 1)) is not None
    want = _highest(jfa.window_batched_attention, jq, jb, heads)
    got = tfa.window_batched_attention(tq, tb, heads)
    assert got.shape == (g, n, heads * dh) and got.dtype == tq.dtype
    _compare(got, want, dtype)


def _fused_case(kind, dtype, shift, per_window, heads=4, dh=32, pad_to=None):
    """One fused call in both packages. heads·dh = 128 is its own 128-lane
    section, so both get the same map; ``pad_to`` gives the JAX layout with
    padded sections to both (the port takes the stride from ``dh``)."""
    win = (4, 4)
    b, hp, wp = (2, 8, 8) if kind == "slab" else (4, 12, 12)
    hd = heads * dh
    sec = hd if pad_to is None else pad_to
    n, nwin = win[0] * win[1], (hp // win[0]) * (wp // win[1])
    nwp = nwin if per_window else 1
    real = _randn(7, b, hp, wp, 3, hd, scale=0.5)
    qkv_map = np.zeros((b, hp, wp, 3, sec), np.float32)
    qkv_map[..., :hd] = real
    qkv_map = qkv_map.reshape(b, hp, wp, 3 * sec)
    bias = _randn(8, nwp, heads, n, n, scale=0.5)
    jplan_fn = (jfa.window_fused_plan if kind == "slab"
                else jfa.window_fused_flat_plan)
    tplan_fn = (tfa.window_fused_plan if kind == "slab"
                else tfa.window_fused_flat_plan)
    itemsize = 4 if dtype == "float32" else 2
    jplan = jplan_fn(b, hp, wp, *win, heads, dh, nwp, itemsize)
    tplan = tplan_fn(b, hp, wp, *win, heads, dh, nwp, itemsize)
    assert jplan is not None and tplan is not None and tplan[0] == kind
    (jq, jb), (tq, tb) = _both(qkv_map, bias, dtype)
    want = _highest(jfa.fused_window_attention, jq, jb, heads, win, shift,
                    dh=dh, plan=jplan)
    got = tfa.fused_window_attention(tq, tb, heads, win, shift, dh=dh,
                                     plan=tplan)
    assert got.shape == (b, hp, wp, sec) and got.dtype == tq.dtype
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["slab", "flat"])
@pytest.mark.parametrize("shift,per_window", [
    ((0, 0), False), ((2, 2), True), ((1, 3), True), ((2, 0), True)])
def test_fused_window_matches_jax(dtype, kind, shift, per_window):
    got, want = _fused_case(kind, dtype, shift, per_window)
    _compare(got, want, dtype)


@pytest.mark.parametrize("kind", ["slab", "flat"])
def test_fused_window_takes_the_section_stride(kind):
    """The JAX layout (sections padded to 128 lanes) is one value of the
    port's section stride: same map in, same (B, Hp, Wp, sec) out, zeros in
    the pad lanes."""
    got, want = _fused_case(kind, "float32", (2, 2), True, heads=2, dh=32,
                            pad_to=128)
    _compare(got, want, "float32")
    assert not _np(got)[..., 64:].any()


def test_fused_plans_follow_the_map_width():
    """wp % 8 == 0 → slab, otherwise flat: Swin-T's and SwinV2-T's maps."""
    for wp, win, slab in ((56, 7, True), (28, 7, False), (14, 7, False),
                          (7, 7, False), (56, 8, True), (32, 8, True),
                          (16, 8, True), (8, 8, True)):
        for fn in (tfa.window_fused_plan, jfa.window_fused_plan):
            plan = fn(32, wp, wp, win, win, 3, 32, 1, 2)
            assert (plan is not None) == slab, (wp, win, fn.__module__)
        assert tfa.window_fused_flat_plan(32, wp, wp, win, win, 3, 32, 1,
                                          2)[0] == "flat"
    # outside the function's contract: both packages refuse
    for args in ((32, 56, 56, 7, 7, 3, 96, 1, 2),     # dh does not divide 128
                 (32, 48, 48, 12, 12, 3, 32, 1, 2),   # N = 144 > 128
                 (32, 30, 30, 7, 7, 3, 32, 1, 2)):    # not a window multiple
        for mod in (tfa, jfa):
            assert mod.window_fused_plan(*args) is None
            assert mod.window_fused_flat_plan(*args) is None
    assert tfa.window_pack_plan(8, 144, 3, 32, 1) is None
    assert tfa.window_pack_plan(8, 49, 3, 96, 1) is None
    assert tfa.window_batched_plan(8, 144, 3, 32, 1) is None


def test_plain_versions_differentiate_on_the_cpu():
    qkv, bias = _qkv_bias(4, 16, 2, 16, 2, seed=9)
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    tfa.window_packed_attention(tq, tb, 2).sin().sum().backward()

    def loss(q, b):
        return jnp.sum(jnp.sin(jfa._window_pack_ref(q, b, 2, 16 ** -0.5)))

    with jax.default_matmul_precision("highest"):
        gq, gb = jax.grad(loss, (0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    np.testing.assert_allclose(_np(tq.grad), _np(gq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tb.grad), _np(gb), atol=ATOL, rtol=0)


def test_cpu_wrappers_count_no_launch():
    tfa.reset_launch_counts()
    qkv, bias = _qkv_bias(4, 16, 2, 16, 1)
    tfa.window_packed_attention(torch.from_numpy(qkv), torch.from_numpy(bias), 2)
    tfa.window_batched_attention(torch.from_numpy(qkv), torch.from_numpy(bias), 2)
    tq = torch.from_numpy(qkv).requires_grad_()
    tfa.window_packed_attention(tq, torch.from_numpy(bias), 2).sum().backward()
    assert set(tfa.LAUNCHES) >= {
        "window_packed_attention", "window_batched_attention",
        "window_fused_slab_attention", "window_fused_flat_attention",
        "window_attention_bwd"}
    assert len(tfa.LAUNCHES) == 16
    assert not any(tfa.LAUNCHES.values())


# ---------------------------------------------------------------------------
# shifted_window_attention on every route, through both packages' hooks

_ROUTES = {
    # route: (FORCE_FUSED_WINDOW, FORCE_PACK_PATH, FORCE_BATCHED_WINDOW)
    "fused": (True, False, False),
    "batched": (False, None, True),
    "pack": (False, True, False),
    "split": (False, False, False),
}


def _swa_inputs(b, hw, c, heads, win, seed=11, qkv_bias=True):
    n = win[0] * win[1]
    return dict(
        x=_randn(seed, b, *hw, c),
        qkv_k=_randn(seed + 1, c, 3 * c, scale=0.1),
        qkv_b=_randn(seed + 2, 3 * c, scale=0.1) if qkv_bias else None,
        proj_k=_randn(seed + 3, c, c, scale=0.1),
        proj_b=_randn(seed + 4, c, scale=0.1),
        rel=_randn(seed + 5, heads, n, n, scale=0.05))


def _run_swa(mod, conv, inp, route, heads, win, shift, logit_scale=None,
             mask_padding=False):
    """``shifted_window_attention`` of one package under one route's hooks.
    ``conv`` turns a numpy array (or None) into the package's array."""
    fused, pack, batched = _ROUTES[route]
    old = (mod.FORCE_FUSED_WINDOW, mod.FORCE_PACK_PATH,
           mod.FORCE_BATCHED_WINDOW)
    mod.FORCE_FUSED_WINDOW, mod.FORCE_PACK_PATH = fused, pack
    mod.FORCE_BATCHED_WINDOW = batched
    try:
        return mod.shifted_window_attention(
            conv(inp["x"]), conv(inp["qkv_k"]), conv(inp["qkv_b"]),
            conv(inp["proj_k"]), conv(inp["proj_b"]), conv(inp["rel"]),
            window_size=win, num_heads=heads, shift_size=shift,
            logit_scale=conv(logit_scale), mask_padding=mask_padding)
    finally:
        (mod.FORCE_FUSED_WINDOW, mod.FORCE_PACK_PATH,
         mod.FORCE_BATCHED_WINDOW) = old


def _jconv(a):
    return None if a is None else jnp.asarray(a)


def _tconv(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# geometry per route: the JAX plans need g % 32 == 0 at dh 4 (pack), whole
# packs per slab at dh 32 (fused), g % 8 == 0 (batched)
_GEOM = {
    "fused": dict(b=4, c_per_head=32, heads=2),
    "batched": dict(b=8, c_per_head=4, heads=2),
    "pack": dict(b=8, c_per_head=4, heads=2),
    "split": dict(b=2, c_per_head=4, heads=2),
}

_SWA_CASES = [
    # (label, hw, win, shift, cosine, mask_padding)
    ("no shift", (8, 8), (4, 4), (0, 0), False, False),
    ("shifted", (8, 8), (4, 4), (2, 2), False, False),
    ("cosine shifted", (8, 8), (4, 4), (2, 2), True, False),
    ("indivisible map", (7, 6), (4, 4), (2, 2), False, False),
    ("pad mask", (7, 7), (4, 4), (2, 2), False, True),
    ("pad mask no shift", (7, 7), (4, 4), (0, 0), False, True),
    ("window covers the map", (4, 4), (4, 4), (2, 2), False, False),
]


@pytest.mark.parametrize("route", list(_ROUTES))
@pytest.mark.parametrize("label,hw,win,shift,cosine,mask_padding", _SWA_CASES,
                         ids=[c[0] for c in _SWA_CASES])
def test_shifted_window_attention_matches_jax(route, label, hw, win, shift,
                                              cosine, mask_padding):
    geo = _GEOM[route]
    heads = geo["heads"]
    b = geo["b"] * (4 if hw == (4, 4) and route != "split" else 1)
    inp = _swa_inputs(b, hw, heads * geo["c_per_head"], heads, win)
    ls = np.full((heads, 1, 1), np.log(10.0), np.float32) + \
        _randn(21, heads, 1, 1, scale=0.3) if cosine else None
    want = _highest(_run_swa, JW, _jconv, inp, route, heads, win, shift, ls,
                    mask_padding)
    TW.ROUTE_LOG = []
    try:
        got = _run_swa(TW, _tconv, inp, route, heads, win, shift, ls,
                       mask_padding)
        taken = list(TW.ROUTE_LOG)
    finally:
        TW.ROUTE_LOG = None
    assert got.shape == inp["x"].shape
    assert len(taken) == 1 and taken[0].startswith(route)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_flat_route_at_swin_stage3_matches_jax():
    """14×14 map, window 7, shift 3: wp % 8 != 0, so both packages take the
    flat fused kernel."""
    heads, win = 4, (7, 7)
    inp = _swa_inputs(4, (14, 14), heads * 32, heads, win, seed=31)
    want = _highest(_run_swa, JW, _jconv, inp, "fused", heads, win, (3, 3))
    TW.ROUTE_LOG = []
    try:
        got = _run_swa(TW, _tconv, inp, "fused", heads, win, (3, 3))
        assert TW.ROUTE_LOG == ["fused_flat"]
    finally:
        TW.ROUTE_LOG = None
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw,win,shift", [((8, 8), (4, 4), (2, 2)),
                                          ((14, 14), (7, 7), (3, 3)),
                                          ((7, 6), (4, 4), (2, 1))])
def test_routes_agree_within_the_port(hw, win, shift):
    """Rolled before the projection and un-rolled after the reverse (pack,
    batched, split) or never rolled (fused): the same map."""
    heads = 2
    inp = _swa_inputs(2, hw, heads * 16, heads, win, seed=41)
    outs = {r: _np(_run_swa(TW, _tconv, inp, r, heads, win, shift))
            for r in _ROUTES}
    for r in ("batched", "pack", "split"):
        np.testing.assert_allclose(outs[r], outs["fused"], atol=ATOL, rtol=0)


def test_dropout_warns_once_and_takes_the_split_path():
    heads, win = 2, (4, 4)
    inp = _swa_inputs(2, (8, 8), 8, heads, win, seed=51)
    TW._pack_dropout_warned = False
    TW.ROUTE_LOG = []
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(2):
                out = TW.shifted_window_attention(
                    _tconv(inp["x"]), _tconv(inp["qkv_k"]), None,
                    _tconv(inp["proj_k"]), None, None, window_size=win,
                    num_heads=heads, shift_size=(0, 0),
                    attention_dropout=0.5, deterministic=False,
                    generator=torch.Generator().manual_seed(0))
        assert TW.ROUTE_LOG == ["split", "split"]
    finally:
        TW.ROUTE_LOG = None
    assert sum("pack kernel" in str(r.message) for r in rec) == 1
    assert out.shape == inp["x"].shape and bool(torch.isfinite(out).all())
    # deterministic: the rate is ignored and a kernel route is kept (four
    # windows of an 8-wide map: the fused slab kernel)
    TW.ROUTE_LOG = []
    try:
        TW.shifted_window_attention(
            _tconv(inp["x"]), _tconv(inp["qkv_k"]), None,
            _tconv(inp["proj_k"]), None, None, window_size=win,
            num_heads=heads, shift_size=(0, 0), attention_dropout=0.5)
        assert TW.ROUTE_LOG == ["fused_slab"]
    finally:
        TW.ROUTE_LOG = None


# ---------------------------------------------------------------------------
# routing of the two ImageNet presets at batch 32: the port against the JAX
# package as it routes on a TPU


def _preset_blocks(name):
    """(label, map size, channels, heads, window, shift) of every block."""
    args = get_args(name)
    assert args == jget_args(name)
    size = args["image_size"] // args["patch_size"][0]
    blocks = []
    for stage, (depth, heads) in enumerate(zip(args["depths"],
                                               args["num_heads"])):
        for layer in range(depth):
            shift = tuple(0 if layer % 2 == 0 else w // 2
                          for w in args["window_size"])
            blocks.append((f"stage{stage}_block{layer}", size,
                           args["embed_dim"] * 2 ** stage, heads,
                           tuple(args["window_size"]), shift))
        size = -(-size // 2)
    return blocks


def _jax_tpu_route(monkeypatch, b, size, c, heads, win, shift, cosine):
    """The JAX router's choice with the backend name faked inside windows.py
    only and the kernel functions stubbed (they cannot lower here), traced
    abstractly: nothing of the full-size block is computed."""
    taken = []

    class FakeJax:
        def __getattr__(self, k):
            return getattr(jax, k)

        @staticmethod
        def default_backend():
            return "tpu"

    def fused(qkv, bias, heads, window, shift, dh=None, scale=None,
              plan=None):
        taken.append("fused_flat" if len(plan) == 3 else "fused_slab")
        return qkv[..., : qkv.shape[-1] // 3]

    def stub(name):
        def fn(qkv, bias, heads, *a, **k):
            taken.append(name)
            return qkv[..., : qkv.shape[-1] // 3]
        return fn

    def split(q, k, v, **kw):
        taken.append("split")
        return q

    monkeypatch.setattr(JW, "FORCE_FUSED_WINDOW", None)
    monkeypatch.setattr(JW, "FORCE_PACK_PATH", None)
    monkeypatch.setattr(JW, "FORCE_BATCHED_WINDOW", None)
    monkeypatch.setattr(JW, "fused_window_attention", fused)
    monkeypatch.setattr(JW, "window_packed_attention", stub("pack"))
    monkeypatch.setattr(JW, "window_batched_attention", stub("batched"))
    monkeypatch.setattr(JW, "dot_product_attention", split)
    monkeypatch.setattr(JW, "jax", FakeJax())
    n = win[0] * win[1]
    bf = jnp.bfloat16
    sds = jax.ShapeDtypeStruct
    ls = (sds((heads, 1, 1), jnp.float32),) if cosine else ()

    def call(x, qk, qb, pk, pb, rel, *ls):
        return JW.shifted_window_attention(
            x, qk, qb, pk, pb, rel, win, heads, shift,
            logit_scale=ls[0] if ls else None)

    jax.eval_shape(call, sds((b, size, size, c), bf), sds((c, 3 * c), bf),
                   sds((3 * c,), bf), sds((c, c), bf), sds((c,), bf),
                   sds((heads, n, n), jnp.float32), *ls)
    assert len(taken) == 1
    return taken[0]


def _port_route(monkeypatch, b, size, c, heads, win, shift, cosine):
    """The port's choice, by the name it records; shapes only (meta
    tensors), with the attention functions stubbed."""
    def stub(qkv, *a, **k):
        return qkv[..., : qkv.shape[-1] // 3]

    for fn in ("fused_window_attention", "window_packed_attention",
               "window_batched_attention"):
        monkeypatch.setattr(TW, fn, stub)
    monkeypatch.setattr(TW, "dot_product_attention",
                        lambda q, k, v, **kw: q)
    for hook in ("FORCE_FUSED_WINDOW", "FORCE_PACK_PATH",
                 "FORCE_BATCHED_WINDOW"):
        monkeypatch.setattr(TW, hook, None)
    monkeypatch.setattr(TW, "ROUTE_LOG", [])
    n = win[0] * win[1]

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    TW.shifted_window_attention(
        meta(b, size, size, c), meta(c, 3 * c), meta(3 * c), meta(c, c),
        meta(c), meta(heads, n, n, dtype=torch.float32), win, heads, shift,
        logit_scale=meta(heads, 1, 1, dtype=torch.float32) if cosine else None)
    assert len(TW.ROUTE_LOG) == 1
    return TW.ROUTE_LOG[0]


_EXPECTED_ROUTES = {
    "swint_224_imagenet": ["batched", "fused_slab", "batched", "fused_flat"]
    + ["fused_flat"] * 6 + ["batched", "batched"],
    "swinv2t_224_imagenet": ["batched", "pack", "batched", "pack"]
    + ["pack"] * 6 + ["batched", "batched"],
}


@pytest.mark.parametrize("preset", list(_EXPECTED_ROUTES))
@pytest.mark.parametrize("index", range(12))
def test_preset_routing_equals_jax_tpu_routing_at_batch_32(monkeypatch,
                                                           preset, index):
    label, size, c, heads, win, shift = _preset_blocks(preset)[index]
    cosine = preset.startswith("swinv2")
    want = _jax_tpu_route(monkeypatch, 32, size, c, heads, win, shift, cosine)
    got = _port_route(monkeypatch, 32, size, c, heads, win, shift, cosine)
    assert got == want == _EXPECTED_ROUTES[preset][index], label


@pytest.mark.parametrize("preset", list(_EXPECTED_ROUTES))
def test_port_routing_does_not_depend_on_the_batch(monkeypatch, preset):
    cosine = preset.startswith("swinv2")
    for b in (1, 8):
        routes = [_port_route(monkeypatch, b, size, c, heads, win, shift,
                              cosine)
                  for _, size, c, heads, win, shift in _preset_blocks(preset)]
        assert routes == _EXPECTED_ROUTES[preset]


# ---------------------------------------------------------------------------
# PatchMerging


def _merge_params(c, out_first, seed):
    norm_dim = 2 * c if out_first else 4 * c
    return {"norm": {"scale": 1 + _randn(seed, norm_dim, scale=0.1),
                     "bias": _randn(seed + 1, norm_dim, scale=0.1)},
            "reduction": {"kernel": _randn(seed + 2, 4 * c, 2 * c, scale=0.2),
                          "bias": _randn(seed + 3, 2 * c, scale=0.1)}}


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("hw", [(4, 4), (5, 7), (1, 6)])
def test_patch_merging_matches_jax(v2, hw):
    from vision_transformers_tpu_torch.utils.port_jax import (
        swin_state_dict_from_jax)

    c = 6
    x = _randn(61, 2, *hw, c)
    params = _merge_params(c, v2, 62)
    jmod = (JW.PatchMergingV2 if v2 else JW.PatchMerging)()
    want = _highest(jmod.apply, {"params": params}, jnp.asarray(x))
    tmod = (TW.PatchMergingV2 if v2 else TW.PatchMerging)(c)
    tmod.load_state_dict(swin_state_dict_from_jax(params), strict=True)
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 2 * c)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
