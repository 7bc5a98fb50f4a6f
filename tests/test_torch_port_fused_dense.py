"""The port's ``ln_dense`` (fused LayerNorm + Dense + GELU) against the JAX
package's.

Same numpy inputs on both sides, fp32 on the CPU: the JAX op runs its
Pallas kernel in interpret mode (as ``tests/test_fused_dense.py`` runs it),
the port's wrapper its plain version (a CPU tensor never launches the
kernel). JAX runs under the highest matmul precision. Tolerances: 1e-5 on
outputs of O(1) (summation order only), 1e-4 on the gradients of all five
inputs (sums over 48 rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops import fused_dense as jfd
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.ops import fused_dense as tfd

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
ACTIVATIONS = [None, "gelu_tanh", "gelu_erf"]


def _inputs(b=2, s=24, d=64, n=128, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(b, s, d).astype(f), (1 + 0.1 * rng.randn(d)).astype(f),
            (0.1 * rng.randn(d)).astype(f), (0.1 * rng.randn(d, n)).astype(f),
            (0.1 * rng.randn(n)).astype(f))


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kw)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_ln_dense_matches_jax(activation, with_bias):
    x, g, b, w, bias = _inputs()
    bias = bias if with_bias else None
    want = _jax(jfd.ln_dense, jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                jnp.asarray(w), None if bias is None else jnp.asarray(bias),
                activation=activation)
    got = tfd.ln_dense(*_t(x, g, b, w), None if bias is None
                       else torch.from_numpy(bias), activation=activation)
    assert got.shape == (2, 24, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL,
                               rtol=0)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_ln_dense_gradients_match_jax(activation):
    """d/d(x, gamma, beta, w, bias) of sum(sin(ln_dense(...))) against
    ``jax.grad`` through the JAX op (its custom_vjp: a jnp recompute)."""
    arrays = _inputs(b=3, s=16, d=32, n=48, seed=1)

    def jloss(*a):
        return jnp.sum(jnp.sin(jfd.ln_dense(*a, activation=activation)))

    want = _jax(jax.grad(jloss, argnums=tuple(range(5))),
                *map(jnp.asarray, arrays))
    ts = [t.requires_grad_() for t in _t(*arrays)]
    torch.sin(tfd.ln_dense(*ts, activation=activation)).sum().backward()
    for t, wg in zip(ts, want):
        assert float(np.abs(np.asarray(wg)).max()) > 1e-3  # not all zero
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg),
                                   atol=GRAD_TOL, rtol=0)


def test_ln_dense_takes_a_transposed_linear_weight_and_bf16():
    """w given as the transpose of a torch (N, D) weight gives the same
    result as the row-major (D, N) copy; bf16 rounds the normalised rows and
    the output as the JAX op does (summation order moves at most one bf16
    step of the output)."""
    x, g, b, w, bias = _inputs(seed=2)
    tx, tg, tb, tw, tbias = _t(x, g, b, w, bias)
    wt = tw.t().contiguous().t()  # strides (1, D)
    assert wt.stride() == (1, 64)
    np.testing.assert_array_equal(
        tfd.ln_dense(tx, tg, tb, wt, tbias).numpy(),
        tfd.ln_dense(tx, tg, tb, tw, tbias).numpy())
    want = _jax(jfd.ln_dense, jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                jnp.asarray(b), jnp.asarray(w, jnp.bfloat16),
                jnp.asarray(bias), activation="gelu_tanh")
    got = tfd.ln_dense(tx.bfloat16(), tg, tb, tw.bfloat16(), tbias,
                       activation="gelu_tanh")
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    err = float(np.abs(got.float().numpy()
                       - np.asarray(want, np.float32)).max())
    assert err <= 2 ** -7 * scale


def test_cpu_wrapper_counts_no_launch_and_checks_its_arguments():
    x, g, b, w, bias = _t(*_inputs(b=1, s=4, d=8, n=16))
    tfa.reset_launch_counts()
    x.requires_grad_()
    tfd.ln_dense(x, g, b, w, bias).sum().backward()
    tfd.ln_dense_fwd(x.detach(), g, b, w)
    assert x.grad.shape == x.shape
    assert not any(tfa.LAUNCHES.values()) and "ln_dense" in tfa.LAUNCHES
    with pytest.raises(ValueError, match="activation"):
        tfd.ln_dense(x, g, b, w, activation="relu")
    with pytest.raises(ValueError, match="needs gamma"):
        tfd.ln_dense(x, g, b, w.t())


@pytest.mark.parametrize("dtype,d,n,layout,route", [
    (torch.bfloat16, 768, 2304, "in_out", "tensor_cores"),  # [ln_1 + QKV]
    (torch.bfloat16, 768, 3072, "out_in", "tensor_cores"),  # torch's weight
    (torch.bfloat16, 40, 64, "out_in", "tensor_cores"),
    (torch.bfloat16, 96, 70, "in_out", "cuda_cores"),       # N % 8 != 0
    (torch.bfloat16, 100, 64, "out_in", "cuda_cores"),      # D % 8 != 0
    (torch.float32, 768, 2304, "in_out", "cuda_cores"),
    (torch.float32, 768, 3072, "out_in", "cuda_cores"),
])
def test_ln_dense_route_rule(dtype, d, n, layout, route):
    """Which CUDA launches take the tensor-core kernel: bf16 with D, N and
    W's leading stride multiples of 8, in either weight layout; everything
    else the CUDA-core kernel."""
    w = torch.empty(d, n) if layout == "in_out" else torch.empty(n, d).t()
    ldk, ldn = tfa._weight_strides("w", w)
    assert tfd.ln_dense_route(dtype, d, n, ldk, ldn) == route
