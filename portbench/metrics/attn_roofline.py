"""attn_roofline.infer, attn_roofline.train: the attention's share of its
roofline in a served request or a train step, in %.

The work is the least time of the attention that the model needs at the
cell's shapes (``arith.<family>.attention_calls``; ``arith.roofline``):
forward 4·pairs·Sq·Sk·dh operations, and in a train step also backward
10·pairs·Sq·Sk·dh; q, k, v, out, the lse where the forward keeps one, do,
dq, dk, dv, the bias and its gradient read or written once, no padding.
The count is of the work, whatever kernel does it.

The time is the device time, over the traced iterations, of the port's
attention kernels below and of everything else that the port's attention
functions launch, forward and backward: the PyTorch work around the
kernels, such as the sum of the window backward's score gradient into the
bias gradient, and the rolls and partitions of the fused window backward.
So work moved from that PyTorch code into a kernel, or out of the model,
reads as the gain it is. Moves the cell's images/s.
"""

from portbench.arith.roofline import least_seconds
from portbench.trace import names_matcher

KERNELS = (
    # rows 1 and 7, the packed forward and backward
    "packed_fwd_kernel", "packed_fwd_mma_kernel", "packed_fwd_mma_padded_kernel",
    "packed_fwd_mma_wide_kernel", "packed_fwd_padded_kernel",
    "packed_fwd_wide_kernel",
    "packed_bwd_dq_kernel", "packed_bwd_dq_mma_kernel",
    "packed_bwd_dq_mma_padded_kernel", "packed_bwd_dq_mma_wide_kernel",
    "packed_bwd_dq_padded_kernel", "packed_bwd_dq_wide_kernel",
    "packed_bwd_dkv_kernel", "packed_bwd_dkv_mma_kernel",
    "packed_bwd_dkv_mma_padded_kernel", "packed_bwd_dkv_mma_wide_kernel",
    "packed_bwd_dkv_padded_kernel", "packed_bwd_dkv_wide_kernel",
    # rows 9, 11, 12, 13 forward and row 10 backward, the window kernels
    "window_packed_kernel", "window_packed_mma_kernel",
    "window_batched_kernel", "window_batched_mma_kernel",
    "window_batched_mma_padded_kernel", "window_batched_mma_chunked_kernel",
    "window_batched_chunked_kernel",
    "window_fused_flat_kernel", "window_fused_flat_mma_kernel",
    "window_fused_slab_kernel", "window_fused_slab_mma_kernel",
    "window_bwd_kernel", "window_bwd_mma_kernel", "window_bwd_mma_padded_kernel",
    "window_bwd_mma_chunked_kernel", "window_bwd_chunked_kernel",
)
# the port's attention autograd functions (ops/flash_attention.py), as the
# profiler names their forward and their backward
FUNCTIONS = ("_PackedFlash", "_Flash", "_FlashDropout", "_WindowAttention",
             "_FusedWindowAttention")
WITHIN = FUNCTIONS + tuple(f + "Backward" for f in FUNCTIONS)


def read(ctx):
    if ctx.profile is None:
        return None
    spent = ctx.profile.seconds_launched(names_matcher(KERNELS), WITHIN)
    if spent <= 0.0:
        return None
    directions = ("fwd", "bwd") if ctx.train else ("fwd",)
    calls = ctx.arith.attention_calls(ctx.model_cfg, ctx.batch)
    least = least_seconds(calls, directions, ctx.train) * ctx.profile.iters
    return 100.0 * least / spent
