"""The port's fused attention sub-block (``fused_attention_block``) and the
``USE_FUSED_BLOCK`` inference path of its ViT against the JAX package.

Same numpy inputs on both sides, on the CPU: the JAX op runs its Pallas
kernel in interpret mode (as ``tests/test_flash_attention.py`` runs it), the
port's wrapper its plain version. JAX runs under the highest matmul
precision. A JAX ViT on the CPU never takes its fused branch (the JAX guard
asks for a TPU, vanilla_vit.py:63), so the port's flag-on ViT is held
against the JAX flag-off ViT: the same function. Tolerances: fp32 1e-5 on
outputs and logits of O(1), 1e-4 on the gradients of all seven inputs;
bf16 as stated at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import (
    vanilla_vit as jvit,
)
from vision_transformers_tpu.ops import flash_attention as jfa
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.models.image_classification import (
    vanilla_vit as tvit,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _inputs(b=2, s=17, hd=64, seed=0):
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


@pytest.mark.parametrize("b,s,hd,heads", [(2, 17, 64, 4), (1, 9, 32, 2),
                                          (3, 33, 64, 2)])
def test_fused_block_matches_jax(b, s, hd, heads):
    arrays = _inputs(b, s, hd, seed=s)
    scale = (hd // heads) ** -0.5
    want = _jax(jfa.fused_attention_block, *map(jnp.asarray, arrays), heads,
                scale)
    got = tfa.fused_attention_block(*map(torch.from_numpy, arrays), heads,
                                    scale)
    assert got.shape == (b, s, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL,
                               rtol=0)


def test_fused_block_bf16_matches_jax():
    """bf16 x and weights, fp32 rows: both sides round xn, qkv, the
    unnormalised exp, the attention output and the result to bf16 at the
    same points; a different summation order can move any of them by one
    bf16 step (2^-8 relative), and the result by a few steps of its own
    magnitude: held to 2^-6 of the largest output."""
    arrays = list(_inputs(2, 17, 64, seed=5))
    scale = 16 ** -0.5
    jin = [jnp.asarray(a, jnp.bfloat16) if i in (0, 3, 5) else jnp.asarray(a)
           for i, a in enumerate(arrays)]
    want = np.asarray(_jax(jfa.fused_attention_block, *jin, 4, scale),
                      np.float32)
    tin = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 5):
        tin[i] = tin[i].bfloat16()
    got = tfa.fused_attention_block(*tin, 4, scale)
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2 ** -6 * float(np.abs(want).max())


def test_fused_block_gradients_match_jax():
    """d/d(all seven inputs) of sum(sin(block)) against ``jax.grad`` through
    the JAX op (its custom_vjp: a jnp recompute of ``_fused_block_ref``;
    the port's backward differentiates its plain version, the same function
    in fp32)."""
    arrays = _inputs(1, 9, 32, seed=6)
    heads, scale = 2, 0.25

    def jloss(*a):
        return jnp.sum(jnp.sin(jfa.fused_attention_block(*a, heads, scale)))

    want = _jax(jax.grad(jloss, argnums=tuple(range(7))),
                *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    torch.sin(tfa.fused_attention_block(*ts, heads, scale)).sum().backward()
    for t, wg in zip(ts, want):
        assert t.grad.shape == t.shape
        assert float(np.abs(np.asarray(wg)).max()) > 1e-3
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg),
                                   atol=GRAD_TOL, rtol=0)


def test_fused_block_reads_a_transposed_weight_in_place():
    """The ViT hands its (out, in) Linear weights over as transposed views;
    the result is the one of row-major (in, out) copies, bit for bit."""
    x, g, b, wqkv, bqkv, wout, bout = map(torch.from_numpy, _inputs(seed=7))
    views = (wqkv.t().contiguous().t(), wout.t().contiguous().t())
    assert views[0].stride() == (1, 64)
    got = tfa.fused_attention_block(x, g, b, views[0], bqkv, views[1], bout, 4)
    want = tfa.fused_attention_block(x, g, b, wqkv, bqkv, wout, bout, 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hd,heads,ok", [
    (768, 12, True),    # ViT-B/16, DeiT-B, CPE-ViT-B
    (384, 6, True),     # T2T-ViT-14
    (1024, 16, True),   # ViT-L/16: admitted (the JAX VMEM rule excludes it)
    (192, 3, True),     # ViT-Ti
    (256, 16, True),    # dh 16
    (1280, 16, True),   # ViT-H/14: dh 80, the 128 tile
    (48, 4, True),      # dh 12, the 16 tile
    (100, 3, False),    # indivisible
])
def test_size_rule(hd, heads, ok):
    assert tfa.fused_block_supported(hd, heads) is ok


def _weights(hd, layouts, device="cpu"):
    """Wqkv (hd, 3hd) and Wout (hd, hd) in the named layouts: "in_out"
    row-major, "out_in" the transposed view of torch's (out, in) weight."""
    make = {"in_out": lambda k, n: torch.empty(k, n, device=device),
            "out_in": lambda k, n: torch.empty(n, k, device=device).t()}
    return [make[lay](hd, n) for lay, n in zip(layouts, (3 * hd, hd))]


@pytest.mark.parametrize("dtype,hd,heads,layouts,route", [
    (torch.bfloat16, 768, 12, ("out_in", "out_in"), "tensor_cores"),  # ViT
    (torch.bfloat16, 768, 12, ("in_out", "in_out"), "tensor_cores"),  # JAX's
    (torch.bfloat16, 384, 6, ("out_in", "out_in"), "tensor_cores"),   # T2T
    (torch.bfloat16, 64, 2, ("in_out", "in_out"), "tensor_cores"),    # dh 32
    (torch.bfloat16, 32, 2, ("out_in", "out_in"), "tensor_cores"),    # dh 16
    (torch.bfloat16, 768, 12, ("in_out", "out_in"), "cuda_cores"),  # mixed
    (torch.bfloat16, 768, 12, ("out_in", "in_out"), "cuda_cores"),
    (torch.bfloat16, 1280, 16, ("out_in", "out_in"), "tensor_cores"),  # dh 80
    (torch.float32, 768, 12, ("out_in", "out_in"), "cuda_cores"),
    (torch.float32, 384, 6, ("in_out", "in_out"), "cuda_cores"),
])
def test_fused_block_route_rule(dtype, hd, heads, layouts, route):
    """Which CUDA launches of row 8 take the tensor cores: bf16 at any head
    dim (a width that is a multiple of 8) with both weights in one layout at
    leading strides that are multiples of 8; everything else the CUDA-core
    kernels."""
    strides = [st for w, n in zip(_weights(hd, layouts), ("wqkv", "wout"))
               for st in tfa._weight_strides(n, w)]
    assert tfa.fused_block_route(dtype, hd, heads, tuple(strides)) == route


@pytest.mark.parametrize("lead", [12, 8, 36])
def test_fused_block_route_reads_the_leading_strides(lead):
    """Leading strides that are not multiples of 8 (the 16-byte rows the
    tiles copy) send a bf16 launch to the CUDA cores, in either layout."""
    ok = lead % 8 == 0
    for strides in ((lead, 1, lead, 1), (1, lead, 1, lead)):
        assert tfa.fused_block_route(torch.bfloat16, 64, 4, strides) == \
            ("tensor_cores" if ok else "cuda_cores")


def test_phase_launches_refuse_the_plain_version():
    """``_measure_fused_block_phases`` times phases of the tensor-core
    kernel; on a CPU tensor (the plain version) it raises, not pass."""
    x, g, b, wqkv, bqkv, wout, bout = map(torch.from_numpy, _inputs(seed=8))
    for phases in ((1,), (0, 1, 2, 3)):
        with pytest.raises(ValueError, match="tensor-core kernel only"):
            tfa._measure_fused_block_phases(x, g, b, wqkv, bqkv, wout, bout,
                                            4, phases)


def test_fused_block_route_is_decided_from_the_operands_metadata(
        monkeypatch):
    """Row 8 chooses its route from dtype, widths and strides alone, before
    any build or launch: the rule runs on tensors without data (the meta
    device) while building or loading a kernel raises."""
    from vision_transformers_tpu_torch.ops import _build

    def no_launch(*_a, **_k):
        raise AssertionError("a route rule built or loaded a kernel")

    monkeypatch.setattr(_build, "load", no_launch)
    monkeypatch.setattr(_build, "build", no_launch)
    wqkv, wout = _weights(768, ("out_in", "out_in"), device="meta")
    strides = (*tfa._weight_strides("wqkv", wqkv),
               *tfa._weight_strides("wout", wout))
    assert tfa.fused_block_route(torch.bfloat16, 768, 12, strides) \
        == "tensor_cores"


# ---------------------------------------------------------------------------
# the flag and its guard

CFG = dict(image_size=16, patch_size=4, num_layers=2, num_heads=2,
           hidden_dim=32, mlp_dim=64, num_classes=10)


def _jax_params(module, seed, shape):
    """JAX params drawn with numpy into the shapes ``jax.eval_shape``
    gives (no ``init``): kernels N(0, 1/fan_in), scales 1 + N(0, 0.1), the
    rest N(0, 0.05)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            a = 1 + 0.1 * rng.randn(*leaf.shape)
        else:
            a = 0.05 * rng.randn(*leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture
def fused_flag(monkeypatch):
    monkeypatch.setattr(tvit, "USE_FUSED_BLOCK", True)


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    real = tvit.fused_attention_block
    monkeypatch.setattr(tvit, "fused_attention_block",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a,
                                                                         **k))
    return calls


def test_flag_on_vit_matches_the_jax_vit(fused_flag, fused_calls):
    jmodel = jvit.ViT(**CFG)
    params = _jax_params(jmodel, 1, (1, 16, 16, 3))
    x = np.random.RandomState(2).randn(3, 16, 16, 3).astype(np.float32)
    want = np.asarray(_jax(jmodel.apply, {"params": params}, jnp.asarray(x)))
    model = ViT(**CFG, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert fused_calls == [(3, 17, 32)] * 2  # one fused call per layer
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_TOL, rtol=0)


def test_flag_is_off_by_default_as_in_jax(fused_calls):
    assert tvit.USE_FUSED_BLOCK is False and jvit.USE_FUSED_BLOCK is False
    with torch.no_grad():
        ViT(**CFG, device="cpu")(torch.zeros(1, 16, 16, 3))
    assert fused_calls == []


def test_training_mode_takes_the_packed_path(fused_flag, fused_calls,
                                             monkeypatch):
    packed = []
    real = tfa.packed_flash_attention
    monkeypatch.setattr(
        "vision_transformers_tpu_torch.ops.attention.packed_flash_attention",
        lambda *a, **k: packed.append(1) or real(*a, **k))
    model = ViT(**CFG, device="cpu")
    model.train()
    model(torch.zeros(2, 16, 16, 3)).sum().backward()
    assert fused_calls == [] and packed == [1, 1]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(2, 16, 16, 3))
    assert len(fused_calls) == 2 and packed == [1, 1]


def test_each_guard_condition_turns_the_branch_off(fused_flag, fused_calls):
    model = ViT(**CFG, device="cpu")
    block = model.encoder.encoder_layer_0
    x = torch.zeros(2, 17, 32)
    assert block._use_fused_block(x, False)
    assert not block._use_fused_block(x, True)            # return_weights
    assert not block._use_fused_block(x[None], False)     # not 3-D
    block.train()
    assert not block._use_fused_block(x, False)           # training mode
    block.eval()
    with torch.no_grad():
        _, weights = model(torch.zeros(1, 16, 16, 3), return_weights=True)
    assert fused_calls == [] and len(weights) == 2
    # dh 20 is no guard condition: every head dim has a tile
    odd = ViT(**dict(CFG, hidden_dim=40, mlp_dim=40), device="cpu")
    assert odd.encoder.encoder_layer_0._use_fused_block(
        torch.zeros(1, 17, 40), False)
    with torch.no_grad():
        odd(torch.zeros(1, 16, 16, 3))
    assert fused_calls == [(1, 17, 40)] * 2
    del fused_calls[:]
    quant8 = ViT(**CFG, quant8=True, device="cpu")   # reads int8 weights
    assert not quant8.encoder.encoder_layer_0._use_fused_block(x, False)
    with torch.no_grad():
        quant8(torch.zeros(1, 16, 16, 3))
    assert fused_calls == []
