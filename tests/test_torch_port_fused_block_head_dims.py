"""The fused sub-block (row 8) at every head dim, the small-S backward (row 4)
at every shape the JAX route sends it, and the int8 product at any K and N,
against the JAX package on the CPU.

The JAX fused block has no head-dim term (its rule is a VMEM budget), its
small-S backward refuses no shape below 512² + 1 scores, and its int8
product is ``lax.dot_general`` at any shape. The port's CUDA kernels take
the same (row 8: the next tile up to dh 128, the wide tile above; row 4:
the resident fp32 kernel or its streaming passes; the int8 product
zero-padded to torch._int_mm's multiples of 8). On the CPU the port's
wrappers run their plain versions, which must compute the JAX package's
function there: the same numpy inputs feed both packages, the JAX Pallas
functions run in interpret mode (at most B 2, S 33, but for the one row-4
case at S 197, past the resident fp32 kernel's shared memory), every JAX
oracle is jitted and runs under the highest matmul precision. Tolerances:
fp32 1e-5 · max(1, max|ref|) on block outputs and attention gradients,
1e-4 on the block's gradients and on model logits; bf16 as stated at its
test; the int8 product bit for bit.

The kernels themselves are held against these plain versions in
tests/test_torch_port_kernels.py and chip_smoke.py (phase 7f), on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu.ops import quant as jquant
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.models.image_classification import (
    vanilla_vit as tvit,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import quant
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

ATOL = 1e-5
GRAD_TOL = 1e-4
MODEL_ATOL = 1e-4


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


def _jit(fn):
    """``fn`` jitted, traced and run under the highest matmul precision."""
    jitted = jax.jit(fn)

    def run(*args):
        with jax.default_matmul_precision("highest"):
            return jitted(*args)

    return run


def _block_inputs(b, s, hd, seed):
    """x, gamma, beta (1, hd), wqkv (hd, 3hd), bqkv (1, 3hd), wout, bout."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(b, s, hd).astype(f),
            (1 + 0.1 * rng.randn(1, hd)).astype(f),
            (0.1 * rng.randn(1, hd)).astype(f),
            (rng.randn(hd, 3 * hd) / np.sqrt(hd)).astype(f),
            (0.1 * rng.randn(1, 3 * hd)).astype(f),
            (rng.randn(hd, hd) / np.sqrt(hd)).astype(f),
            (0.1 * rng.randn(1, hd)).astype(f))


# ---------------------------------------------------------------------------
# the rules


@pytest.mark.parametrize("hd,heads,ok", [
    (768, 12, True),     # ViT-B/16: dh 64
    (1280, 16, True),    # ViT-H/14: dh 80
    (768, 3, True),      # ViT-B/16's widths at 3 heads: dh 256
    (384, 8, True),      # CaiT-S's attention widths: dh 48
    (768, 8, True),      # dh 96
    (24, 2, True),       # dh 12
    (21, 7, True),       # dh 3: odd
    (100, 3, False),     # heads that do not divide the width
    (64, 0, False),
])
def test_fused_block_rule_takes_every_head_dim(hd, heads, ok):
    """Row 8 admits every head dim whose heads divide the width: the JAX
    rule (a VMEM budget) has no head-dim term, and the port's has no width
    term, so it stays a superset of JAX's."""
    assert tfa.fused_block_supported(hd, heads) is ok


@pytest.mark.parametrize("dh", [3, 12, 48, 80, 96, 160, 256])
def test_fused_block_route_at_any_head_dim(dh):
    """The tensor cores take bf16 at any dh whose width H·dh is a multiple
    of 8 (both weights in one layout); a width off the multiple, fp32 and
    mixed layouts take the CUDA cores."""
    heads = 8
    hd = heads * dh
    in_out = (3 * hd, 1, hd, 1)
    out_in = (1, hd, 1, hd)
    for strides in (in_out, out_in):
        assert tfa.fused_block_route(torch.bfloat16, hd, heads, strides) \
            == "tensor_cores"
        assert tfa.fused_block_route(torch.float32, hd, heads, strides) \
            == "cuda_cores"
    assert tfa.fused_block_route(torch.bfloat16, hd, heads,
                                 (3 * hd, 1, 1, hd)) == "cuda_cores"
    odd = 3 * dh  # three heads: a multiple of 8 only if dh is
    assert tfa.fused_block_route(torch.bfloat16, odd, 3,
                                 (3 * odd, 1, odd, 1)) \
        == ("tensor_cores" if odd % 8 == 0 else "cuda_cores")


@pytest.mark.parametrize("sq,sk,d,ok", [
    (512, 512, 128, True), (513, 512, 64, False), (197, 197, 256, True),
    (512, 512, 256, True), (512, 512, 1024, True), (4, 1000, 64, True),
    (1, 262145, 16, False)])
def test_small_s_backward_rule_is_the_jax_threshold(sq, sk, d, ok):
    """Row 4's route is the JAX package's alone (``_flash_attention_bwd``:
    Sq·Sk < 512² + 1 under ``USE_PALLAS_BWD``), at every head dim; the
    fp32 kernel's shared-memory footprint only chooses between its resident
    kernel and the streaming passes inside the entry."""
    assert tfa.flash_bwd_supported(sq, sk, d) is ok
    assert tfa._PALLAS_BWD_MIN_SCORES == jfa._PALLAS_BWD_MIN_SCORES
    assert (sq * sk < jfa._PALLAS_BWD_MIN_SCORES) is ok


# ---------------------------------------------------------------------------
# row 8


@functools.lru_cache(maxsize=None)
def _jax_block(heads, scale):
    return _jit(lambda *a: jfa.fused_attention_block(*a, heads, scale))


@pytest.mark.parametrize("dh,heads,b,s", [(12, 2, 2, 17), (48, 2, 2, 33),
                                          (80, 2, 1, 17), (256, 2, 1, 9)])
def test_fused_block_matches_jax_at_head_dim(dh, heads, b, s):
    """The plain version against ``fused_attention_block`` (its Pallas
    kernel in interpret mode) at dh 12 (the 16 tile), 48 (64), 80 (128) and
    256 (the wide tile)."""
    hd = heads * dh
    arrays = _block_inputs(b, s, hd, seed=dh)
    scale = dh ** -0.5
    want = _jax_block(heads, scale)(*map(jnp.asarray, arrays))
    got = tfa.fused_attention_block(*map(torch.from_numpy, arrays), heads,
                                    scale)
    assert got.shape == (b, s, hd)
    _close(got, want)


def test_fused_block_bf16_matches_jax_at_dh48():
    """bf16 x and weights, fp32 rows, dh 48: both sides round xn, qkv, the
    unnormalised exp, the attention output and the result to bf16 at the
    same points; a different summation order can move any of them by one
    bf16 step, and the result by a few steps of its own magnitude: held to
    2^-6 of the largest output, as tests/test_torch_port_fused_block.py
    holds dh 16."""
    heads, dh = 2, 48
    arrays = list(_block_inputs(2, 17, heads * dh, seed=5))
    scale = dh ** -0.5
    jin = [jnp.asarray(a, jnp.bfloat16) if i in (0, 3, 5) else jnp.asarray(a)
           for i, a in enumerate(arrays)]
    want = _np(_jax_block(heads, scale)(*jin))
    tin = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 5):
        tin[i] = tin[i].bfloat16()
    got = tfa.fused_attention_block(*tin, heads, scale)
    assert got.dtype == torch.bfloat16
    err = float(np.abs(_np(got) - want).max())
    assert err <= 2 ** -6 * float(np.abs(want).max())


def test_fused_block_gradients_match_jax_at_dh48():
    """d/d(all seven inputs) of sum(sin(block)) at dh 48 against
    ``jax.grad`` through the JAX op's custom_vjp (a jnp recompute of
    ``_fused_block_ref``)."""
    heads, dh = 2, 48
    arrays = _block_inputs(1, 9, heads * dh, seed=6)
    scale = dh ** -0.5

    def jloss(*a):
        return jnp.sum(jnp.sin(jfa.fused_attention_block(*a, heads, scale)))

    want = _jit(jax.grad(jloss, argnums=tuple(range(7))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    torch.sin(tfa.fused_attention_block(*ts, heads, scale)).sum().backward()
    for t, wg in zip(ts, want):
        assert t.grad.shape == t.shape
        assert float(np.abs(np.asarray(wg)).max()) > 1e-3
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg),
                                   atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("hidden,heads", [(96, 2), (512, 2)])
def test_flag_on_vit_matches_the_jax_vit(hidden, heads, monkeypatch):
    """A 2-layer ViT at dh 48 and at dh 256 with the port's flag on (one
    fused call a layer) against the JAX ViT, whose CPU guard runs its
    modular branch (it fuses only on a TPU): the same function, logits to
    1e-4 · max(1, max|ref|)."""
    monkeypatch.setattr(tvit, "USE_FUSED_BLOCK", True)
    calls = []
    real = tvit.fused_attention_block
    monkeypatch.setattr(tvit, "fused_attention_block",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    kw = dict(image_size=16, patch_size=4, num_layers=2, num_heads=heads,
              hidden_dim=hidden, mlp_dim=2 * hidden, num_classes=10)
    jmodel = JViT(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.RandomState(hidden)
    params = jax.tree.map(
        lambda s: (rng.randn(*s.shape) * (0.05 if len(s.shape) > 1 else 0.3)
                   ).astype(np.float32), shapes)
    x = np.random.RandomState(2).randn(2, 16, 16, 3).astype(np.float32)
    want = _jit(lambda p, x_: jmodel.apply({"params": p}, x_))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    model = ViT(**kw, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert calls == [(2, 17, hidden)] * 2
    assert np.abs(_np(want)).max() > 0.1
    _close(got, want, MODEL_ATOL)


# ---------------------------------------------------------------------------
# row 4


def test_small_s_backward_matches_jax_at_s197_d160():
    """Row 4's plain version at S 197, D 160 (G 2; past the resident fp32
    kernel's shared memory, so the card streams it) against
    ``_flash_bwd_pallas`` in interpret mode, kv_valid < Sk."""
    g, s, d, kv_valid = 2, 197, 160, 190
    rng = np.random.RandomState(40)
    q, k, v, do = (rng.randn(g, s, d).astype(np.float32) * c
                   for c in (0.3, 0.3, 1.0, 1.0))
    assert tfa.flash_bwd_supported(s, s, d)
    assert tfa.flash_bwd_smem_bytes(s, s, d) > tfa._SMEM_LIMIT
    t = [torch.from_numpy(a).unsqueeze(0) for a in (q, k, v, do)]
    out, lse = tfa.flash_attention_fwd(*t[:3], kv_valid=kv_valid)
    got = tfa.flash_attention_bwd(*t[:3], out, lse, t[3], kv_valid=kv_valid)
    want = _jit(lambda *a: jfa._flash_bwd_pallas(*a, d ** -0.5, kv_valid))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(_np(out)[0]), jnp.asarray(_np(lse).reshape(g, s, 1)),
        jnp.asarray(do))
    for a, w in zip(got, want):
        _close(a[0], w)


# ---------------------------------------------------------------------------
# the int8 product


def test_int8_matmul_at_k100_n36_matches_jax():
    """K 100 and N 36, neither a multiple of 8: the port pads both with
    zeros (on every device) and slices N back; the result is JAX's
    ``int8_matmul`` bit for bit, and the product the unpadded int32 one."""
    x = np.random.RandomState(50).randn(5, 100).astype(np.float32)
    w = np.random.RandomState(51).randn(36, 100).astype(np.float32) * 0.1
    b = np.random.RandomState(52).randn(36).astype(np.float32) * 0.1
    jq, js = jquant.quantize_kernel(jnp.asarray(w.T))
    want = jquant.int8_matmul(jnp.asarray(x), jq, js, jnp.asarray(b))
    tq, ts = quant.quantize_kernel(torch.from_numpy(w))
    got = quant.int8_matmul(torch.from_numpy(x), tq, ts, torch.from_numpy(b))
    assert tuple(got.shape) == (5, 36)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    xq, _ = quant.dynamic_quant_rows(torch.from_numpy(x))
    assert torch.equal(quant._int_mm(xq, tq.t()),
                       xq.int() @ tq.t().int())
