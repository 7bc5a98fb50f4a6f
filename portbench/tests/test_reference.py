"""The plain reference against the port's CPU path, at a small width and
depth, in float32: the same weights (made by the benchmark from a seed)
and the same inputs on both sides."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import harness  # noqa: E402
from portbench.reference.common import (  # noqa: E402
    AdamW,
    block_seeds,
    cross_entropy,
)
from tiny import tiny_tree  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tree"))


def _fp32(root, cell):
    ctx = harness.Context(harness.Cell(cell, root), 20240611, CPU)
    ctx.dtype = "float32"
    return ctx


@pytest.mark.parametrize("cell", ["tiny_vit.infer", "tiny_swin.infer"])
def test_reference_logits_match_the_port(root, cell):
    ctx = _fp32(root, cell)
    model = ctx.program_model()
    model.load_state_dict(ctx.weights(), strict=True)
    size = ctx.model_cfg["image_size"]
    x = torch.randn(3, size, size, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x)
        want = ctx.cell.reference.forward(ctx.weights(), x, ctx.model_cfg)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), \
        (got - want).abs().max()
    assert want.abs().max() > 0.1  # random heads: logits that say something


def test_reference_redraws_stochastic_depth(root):
    """Swin in training mode: the port's forward with its dropout generator
    seeded, the reference with the block seeds redrawn by the copied rule;
    logits and the loss gradient agree, and differ from a run that takes
    other seeds."""
    ctx = _fp32(root, "tiny_swin.train")
    m = ctx.model_cfg
    model = ctx.program_model()
    model.load_state_dict(ctx.weights(), strict=True)
    model.train()
    model.dropout_generator.manual_seed(77)
    x = torch.randn(8, 56, 56, 3, generator=torch.Generator().manual_seed(2))
    got = model(x)
    seeds = block_seeds(torch.Generator().manual_seed(77),
                        ctx.cell.reference.seeds_per_forward(m))
    ref_w = ctx.weights()
    want = ctx.cell.reference.forward(ref_w, x, m, seeds=seeds)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    other = block_seeds(torch.Generator().manual_seed(78), len(seeds))
    assert not torch.allclose(
        ctx.cell.reference.forward(ref_w, x, m, seeds=other), want,
        rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_adamw_matches_the_port_optimizer(fused):
    from vision_transformers_tpu_torch.training.optimizers import (
        make_optimizer,
    )

    gen = torch.Generator().manual_seed(3)
    leaves = {"a": torch.randn(70000, generator=gen),
              "b": torch.randn(5, 7, generator=gen)}
    port = [v.clone().requires_grad_() for v in leaves.values()]
    opt = make_optimizer("adamw", 1e-3, weight_decay=0.05,
                         fused=fused).init(port)
    mine = AdamW({k: v.clone() for k, v in leaves.items()}, 1e-3, 0.05)
    for _ in range(3):
        grads = [torch.randn(v.shape, generator=gen) for v in port]
        for p, g in zip(port, grads):
            p.grad = g
        opt.step()
        mine.step(dict(zip(leaves, grads)))
    for p, k in zip(port, leaves):
        assert torch.allclose(p.detach(), mine.params[k], rtol=1e-6,
                              atol=1e-7)


def test_cross_entropy_matches_the_port_loss():
    from vision_transformers_tpu_torch.training.trainer import (
        cross_entropy_with_weights,
    )

    gen = torch.Generator().manual_seed(4)
    logits = torch.randn(6, 10, generator=gen)
    labels = torch.randint(0, 10, (6,), generator=gen)
    weights = torch.tensor([1.0, 1, 1, 0, 1, 0])
    assert torch.allclose(cross_entropy(logits, labels, weights),
                          cross_entropy_with_weights(logits, labels, weights))
