"""The modules under the port's PVT and Twins-SVT against the JAX package
(the whole models are in ``tests/test_torch_port_pvt_twins_models.py``).

Same weights in both packages (JAX params, perturbed from a numpy seed so
that no bias or LayerNorm parameter stays at its initial 0 or 1, converted
by ``pvt_state_dict_from_jax`` / ``twins_state_dict_from_jax`` and loaded
with ``strict=True``), same numpy inputs, fp32 on the CPU, where the port's
attention wrappers take their plain versions. JAX runs under the highest
matmul precision. Tolerance: 1e-5 on outputs and gradients of O(1) after
one module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import (
    twins_svt as jtwins,
)
from vision_transformers_tpu.ops import mlp as jmlp
from vision_transformers_tpu.ops import patch_embed as jpe
from vision_transformers_tpu.ops import sra as jsra
from vision_transformers_tpu_torch.models.image_classification import (
    GroupAttention,
    PosCNN,
)
from vision_transformers_tpu_torch.ops import windows as TW
from vision_transformers_tpu_torch.ops.mlp import Mlp
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed
from vision_transformers_tpu_torch.ops.sra import SpatialReductionAttention
from vision_transformers_tpu_torch.utils.port_jax import (
    twins_state_dict_from_jax,
    vit_state_dict_from_jax,
)

MODULE_TOL = 1e-5


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _perturbed_params(module, seed, *inputs, **kw):
    params = jax.device_get(
        module.init(jax.random.PRNGKey(seed), *inputs, **kw)["params"])
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(
            np.float32), params)


def _apply(module, params, *inputs, **kw):
    with jax.default_matmul_precision("highest"):
        return module.apply({"params": params}, *inputs, **kw)


def _load(tmodule, params, convert=vit_state_dict_from_jax):
    result = tmodule.load_state_dict(convert(params), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return tmodule.eval()


def _close(got, want, atol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# modules


@pytest.mark.parametrize("hidden,out", [(None, None), (24, None), (24, 5)])
def test_mlp_matches_jax(hidden, out):
    x = _randn(0, 2, 7, 12)
    jm = jmlp.Mlp(hidden_dim=hidden, out_dim=out)
    params = _perturbed_params(jm, 1, jnp.asarray(x))
    tm = _load(Mlp(12, hidden, out), params)
    assert tm.fc1.weight.shape == (hidden or 12, 12)
    _close(tm(torch.from_numpy(x)), _apply(jm, params, jnp.asarray(x)),
           MODULE_TOL)


def test_mlp_init_and_seeded_dropout():
    gen = torch.Generator().manual_seed(0)
    m = Mlp(64, 256, dropout=0.5, generator=gen)
    assert not bool(m.fc1.bias.any()) and not bool(m.fc2.bias.any())
    assert abs(float(m.fc1.weight.detach().std()) - 0.02) < 2e-3   # trunc-normal 0.02
    assert float(m.fc1.weight.detach().abs().max()) <= 2 * 0.02 / 0.8796 + 1e-6
    x = torch.ones(3, 5, 64)
    m.train()
    assert torch.equal(m(x, seed=3), m(x, seed=3))
    assert not torch.equal(m(x, seed=3), m(x, seed=4))
    with pytest.raises(ValueError, match="seed"):
        m(x)
    m.eval()
    assert torch.equal(m(x), m(x, seed=9))
    bf = Mlp(8, dtype=torch.bfloat16)   # tanh GELU in bf16, as the JAX package
    assert bf(torch.ones(1, 8)).dtype == torch.bfloat16


@pytest.mark.parametrize("norm", [True, False])
def test_patch_embed_norm_matches_jax(norm):
    x = _randn(2, 2, 8, 12, 3)
    jm = jpe.PatchEmbed(16, 4, norm=norm)
    params = _perturbed_params(jm, 3, jnp.asarray(x))
    tm = _load(PatchEmbed(16, 4, 3, norm=norm), params)
    assert ("norm.weight" in tm.state_dict()) == norm
    want, jgrid = _apply(jm, params, jnp.asarray(x))
    got, grid = tm(torch.from_numpy(x))
    assert grid == tuple(jgrid) == (2, 3)
    _close(got, want, MODULE_TOL)
    if norm:
        assert tm.norm.eps == 1e-6


_SRA_CASES = [
    # label, grid, sr_ratio, num_cls_tokens, qkv_bias
    ("sr1", (4, 4), 1, 0, True),
    ("sr2", (4, 6), 2, 0, True),
    ("sr2 no qkv bias", (4, 4), 2, 0, False),
    ("indivisible grid", (5, 7), 2, 0, True),
    ("cls token", (4, 4), 2, 1, True),
    ("cls token, indivisible grid", (5, 5), 4, 1, True),
    ("cls token, sr1", (3, 3), 1, 1, True),
]


@pytest.mark.parametrize("label,grid,sr,ncls,qkv_bias", _SRA_CASES,
                         ids=[c[0] for c in _SRA_CASES])
def test_sra_matches_jax(label, grid, sr, ncls, qkv_bias):
    dim, heads = 16, 2
    n = grid[0] * grid[1] + ncls
    x = _randn(4, 2, n, dim)
    jm = jsra.SpatialReductionAttention(dim, heads, sr_ratio=sr,
                                        qkv_bias=qkv_bias,
                                        num_cls_tokens=ncls)
    params = _perturbed_params(jm, 5, jnp.asarray(x), grid)
    tm = _load(SpatialReductionAttention(dim, heads, sr_ratio=sr,
                                         qkv_bias=qkv_bias,
                                         num_cls_tokens=ncls), params)
    sd = tm.state_dict()
    assert ("q.bias" in sd) == qkv_bias and ("kv.bias" in sd) == qkv_bias
    assert "proj.bias" in sd and (("sr.bias" in sd) == (sr > 1))
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, grid)
    _close(got, _apply(jm, params, jnp.asarray(x), grid), MODULE_TOL)
    # and its gradient in x, through the split-head attention with Sq != Sk
    cot = _randn(6, 2, n, dim)
    (gx,) = torch.autograd.grad(got, tx, torch.from_numpy(cot))
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda a: jnp.sum(jm.apply(
            {"params": params}, a, grid) * cot))(jnp.asarray(x))
    _close(gx, want, MODULE_TOL)


def test_sra_rejects_indivisible_heads_and_needs_a_seed_for_dropout():
    with pytest.raises(ValueError, match="divided by num_heads"):
        SpatialReductionAttention(10, 3)
    m = SpatialReductionAttention(8, 2, attn_drop=0.2)
    m.train()
    with pytest.raises(ValueError, match="seed"):
        m(torch.zeros(1, 4, 8), (2, 2))
    a = m(torch.ones(1, 4, 8), (2, 2), seed=1)
    assert torch.equal(a, m(torch.ones(1, 4, 8), (2, 2), seed=1))


def test_pos_cnn_matches_jax():
    x = _randn(7, 2, 5 * 6, 8)
    jm = jtwins.PosCNN()
    params = _perturbed_params(jm, 8, jnp.asarray(x), (5, 6))
    assert params["proj"]["kernel"].shape == (3, 3, 1, 8)  # flax depthwise
    sd = twins_state_dict_from_jax({"pos_block0": params})
    assert sd["pos_block0.proj.weight"].shape == (8, 1, 3, 3)
    tm = PosCNN(8)
    tm.load_state_dict({k.removeprefix("pos_block0."): v
                        for k, v in sd.items()}, strict=True)
    _close(tm(torch.from_numpy(x), (5, 6)),
           _apply(jm, params, jnp.asarray(x), (5, 6)), MODULE_TOL)


@pytest.mark.parametrize("grid,route", [((8, 8), "fused_flat"),
                                        ((7, 7), "batched"),
                                        ((4, 4), "batched"),
                                        ((14, 14), "fused_flat")])
def test_group_attention_matches_jax(grid, route):
    """LSA with ws 7: an 8×8 grid is padded to 14×14 and the padded keys are
    masked (a pure pad-mask bias per window; four windows of a map 14 wide:
    the flat fused kernel); 7×7 is one window without any bias and 4×4 one
    padded window with its mask (batched); 14×14 is four windows without a
    bias. Outputs and the gradient in x and the qkv kernel."""
    dim, heads, ws = 16, 2, 7
    n = grid[0] * grid[1]
    x = _randn(9, 2, n, dim)
    jm = jtwins.GroupAttention(dim, heads, ws=ws, qkv_bias=True)
    params = _perturbed_params(jm, 10, jnp.asarray(x), grid)
    tm = _load(GroupAttention(dim, heads, ws=ws, qkv_bias=True), params)
    assert set(tm.state_dict()) == {"qkv_kernel", "qkv_bias_p", "proj_kernel",
                                    "proj_bias_p"}
    tx = torch.from_numpy(x).requires_grad_()
    TW.ROUTE_LOG = []
    try:
        got = tm(tx, grid)
        assert TW.ROUTE_LOG == [route]
    finally:
        TW.ROUTE_LOG = None
    _close(got, _apply(jm, params, jnp.asarray(x), grid), MODULE_TOL)
    cot = _randn(11, 2, n, dim)
    gx, gk = torch.autograd.grad(got, (tx, tm.qkv_kernel),
                                 torch.from_numpy(cot))
    with jax.default_matmul_precision("highest"):
        want_p, want_x = jax.grad(lambda p, a: jnp.sum(jm.apply(
            {"params": p}, a, grid) * cot), (0, 1))(params, jnp.asarray(x))
    _close(gx, want_x, MODULE_TOL)
    _close(gk, want_p["qkv_kernel"], MODULE_TOL)
