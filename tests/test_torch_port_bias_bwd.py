"""The biased split-head backward's host side, on the CPU: which calls the
kernel of ``csrc/flash_attention_bias_bwd.cu`` takes on the card and which
keep the plain version, the dq pass's plan as a pure function of the shape,
and the two-term bf16 split that keeps the kernel's p and dS near fp32. The
kernel itself runs only on the card (``tests/test_torch_port_kernels.py``,
``-k bias_bwd``)."""

import math

import pytest
import torch

from vision_transformers_tpu_torch.ops import flash_attention as tfa

_LIMIT = 232448  # shared memory a block may ask for on the H100


@pytest.mark.parametrize("d", [1, 12, 16, 32, 64, 80, 128])
def test_bf16_up_to_128_takes_the_kernel(d):
    assert tfa.bias_bwd_route(torch.bfloat16, 256, 256, d) == "kernel"
    assert tfa.bias_bwd_route(torch.bfloat16, 49, 2048, d) == "kernel"


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 129),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 32)])
def test_fp32_and_wide_heads_keep_the_plain_version(dtype, d):
    assert tfa.bias_bwd_route(dtype, 256, 256, d) == "plain"


@pytest.mark.parametrize("d,largest", [(16, 3432), (32, 3304), (64, 3048),
                                       (80, 2536), (128, 2536)])
def test_keys_past_the_dq_pass_shared_memory_keep_the_plain_version(
        d, largest):
    """16 query rows of fp32 dbias sums and the K/V ring fill 227 KB at
    these Sk; one key more keeps the plain version."""
    assert tfa.bias_bwd_route(torch.bfloat16, 64, largest, d) == "kernel"
    assert tfa.bias_bwd_route(torch.bfloat16, 64, largest + 1, d) == "plain"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_is_the_plan(dtype):
    """One rule: bf16 takes the kernel exactly where the plan has a plan."""
    for s_q, s_k, d in ((256, 256, 32), (1, 1, 1), (64, 3304, 32),
                        (64, 3305, 32), (49, 2048, 129), (1224, 1224, 128),
                        (8, 190000, 64), (300, 4000, 16)):
        planned = tfa.bias_bwd_plan(8, 2, s_q, s_k, d) is not None
        want = "kernel" if planned and dtype == torch.bfloat16 else "plain"
        assert tfa.bias_bwd_route(dtype, s_q, s_k, d) == want


# (label, G·H, bias_g, N, rows, chunks): SwinV2-B @256 w16 at batch 128
# (stages 1 and 2 unshifted, bias_g = H, and shifted, bias_g = windows·H;
# stage 3 one unshifted window of 16 heads), then windows of 144 (SwinV2 at
# w12), 576 (w24) and 1224 tokens.
_PLANS = [
    ("stage 1", 2048 * 4, 4, 256, 64, 64),
    ("stage 1 shifted", 2048 * 4, 16 * 4, 256, 64, 5),
    ("stage 2", 512 * 8, 8, 256, 64, 32),
    ("stage 2 shifted", 512 * 8, 4 * 8, 256, 64, 9),
    ("stage 3", 128 * 16, 16, 256, 64, 16),
    ("N 144", 2048 * 4, 16 * 4, 144, 64, 6),
    ("N 576", 512 * 16, 16 * 16, 576, 64, 1),
    ("N 1224", 64 * 8, 8, 1224, 32, 4),
]


@pytest.mark.parametrize("label,groups,bias_g,n,rows,chunks", _PLANS)
def test_plan_of_each_shape(label, groups, bias_g, n, rows, chunks):
    plan = tfa.bias_bwd_plan(groups, bias_g, n, n, 32)
    assert (plan.rows, plan.chunks) == (rows, chunks), label
    q_tiles = math.ceil(n / rows)
    assert plan.blocks == bias_g * q_tiles * chunks >= 2 * 132
    assert plan.smem_bytes == (rows * tfa.bias_bwd_row_floats(n) * 4
                               + 4 * 64 * (32 + 8) * 2) <= _LIMIT
    assert plan.part_bytes == (4 * chunks * bias_g * n * n if chunks > 1
                               else 0)
    # every chunk holds groups: the last one is not empty
    per = math.ceil(groups // bias_g / chunks)
    assert (chunks - 1) * per < groups // bias_g <= chunks * per
    assert plan == tfa.bias_bwd_plan(groups, bias_g, n, n, 32)


@pytest.mark.parametrize("n", [144, 256, 576, 1224])
def test_plan_fits_every_tile_width(n):
    for d in (16, 32, 64, 80, 128):
        plan = tfa.bias_bwd_plan(2048, 64, n, n, d)
        tile = next(t for t in (16, 32, 64, 128) if t >= d)
        assert plan.smem_bytes == (plan.rows * tfa.bias_bwd_row_floats(n) * 4
                                   + 4 * 64 * (tile + 8) * 2) <= _LIMIT


def test_row_floats_avoid_bank_conflicts():
    """Whole column pairs, rows 8 mod 32 floats apart: a warp's float2
    accesses (8 rows × 4 lanes) fill the 32 banks twice."""
    for sk in range(1, 700):
        w = tfa.bias_bwd_row_floats(sk)
        assert w % 32 == 8 and sk <= w < sk + 33
        banks = {(r * w + 2 * t + e) % 32 for r in range(4) for t in range(4)
                 for e in range(2)}
        assert len(banks) == 32


def test_no_broadcast_writes_dbias_in_one_chunk():
    """bias_g = G·H: one group a plane, so one chunk and no partials."""
    plan = tfa.bias_bwd_plan(96, 96, 197, 197, 64)
    assert plan.chunks == 1 and plan.part_bytes == 0


def test_wrapper_on_the_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(4)
    q, k, v, do, out = (torch.randn(4, 2, 20, 16, generator=gen)
                        .to(torch.bfloat16) for _ in range(5))
    bias = torch.randn(2, 2, 20, 20, generator=gen)
    lse = torch.randn(4, 2, 20, generator=gen)
    kw = dict(scale=0.25, kv_valid=17)
    got = tfa.flash_attention_bias_bwd(q, k, v, bias, do, out, lse, **kw)
    want = tfa.flash_attention_bias_bwd_reference(q, k, v, bias, do, out,
                                                  lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tfa.LAUNCHES["flash_attention_bias_bwd"] == 0
    assert tfa.BIAS_BWD["plain_on_card"] == 0  # the CPU is not the card


def test_reset_zeroes_the_plain_on_card_count():
    tfa.BIAS_BWD["plain_on_card"] = 3
    tfa.reset_launch_counts()
    assert tfa.BIAS_BWD["plain_on_card"] == 0


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def test_two_term_split_keeps_the_fp32_product():
    """The kernel's products with p or dS as the A operand take hi·B + lo·B
    (hi = bf16(x), lo = bf16(x − hi)) against bf16 B: about 16 bits of x.
    Relative to the fp32 product its error is below 2^-14; one bf16
    rounding of x (the bias-free backward's) is above 2^-10."""
    gen = torch.Generator().manual_seed(11)
    x = torch.softmax(4 * torch.randn(64, 256, generator=gen), dim=-1)
    b = torch.randn(256, 32, generator=gen).to(torch.bfloat16).float()
    want = x.double() @ b.double()
    hi, lo = _split(x)
    two = hi @ b + lo @ b
    one = hi @ b
    scale = float(want.abs().max())
    assert float((two - want).abs().max()) / scale < 2 ** -14
    assert float((one - want).abs().max()) / scale > 2 ** -10
