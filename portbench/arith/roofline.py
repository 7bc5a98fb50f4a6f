"""The chip's published peaks and the least time of a piece of work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit), the same numbers as ``chip_smoke.py``'s ``PEAK_FLOPS`` and
``HBM_BYTES_PER_S``, copied here so that the benchmark imports nothing of
that script. A roofline share is the least time over the measured time:
the least time is the larger of the operations over the peak rate and the
bytes over the memory bandwidth (``chip_smoke.py::bound_ms``), with each
input read once and each output written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(bytes_moved: float, flops: float, dtype: str = "bfloat16"):
    """(least seconds, "bytes" or "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_work(call: dict, direction: str, train: bool,
                   itemsize: int = 2):
    """(operations, bytes) of one attention call (``arith.<family>.
    attention_calls``) in ``direction`` "fwd" or "bwd": 4·pairs·Sq·Sk·dh
    operations forward, 10·… backward (the scores again, dP, dS and the
    three products); bytes of q, k, v and out forward, of q, k, v, do and
    dq, dk, dv backward (with out and the fp32 lse where the forward keeps
    an lse), the bias read each way and the bias gradient written, each
    once, no padding counted. ``train``: the forward also writes its lse."""
    p, sq, sk, dh = call["pairs"], call["sq"], call["sk"], call["dh"]
    q_bytes = p * sq * dh * itemsize
    kv_bytes = 2 * p * sk * dh * itemsize
    lse_bytes = 4 * p * sq if call["lse"] else 0
    if direction == "fwd":
        ops = 4 * p * sq * sk * dh
        nbytes = 2 * q_bytes + kv_bytes + call["bias_bytes"]
        if train:
            nbytes += lse_bytes
        return ops, nbytes
    ops = 10 * p * sq * sk * dh
    reads = q_bytes + kv_bytes + q_bytes + call["bias_bytes"]  # q, k, v, do
    if call["lse"]:
        reads += q_bytes + lse_bytes                            # out, lse
    writes = q_bytes + kv_bytes + call["dbias_bytes"]
    return ops, reads + writes


def least_seconds(calls, directions, train: bool) -> float:
    """Sum over calls and directions of each call's least time."""
    total = 0.0
    for call in calls:
        for direction in directions:
            ops, nbytes = attention_work(call, direction, train)
            total += bound_s(nbytes, ops)[0]
    return total
