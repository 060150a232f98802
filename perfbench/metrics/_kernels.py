"""Kernel names of the port's hand-written attention kernels, as the
profiler's trace gives them, and the device time a call of each takes."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

# K1, ``csrc/attention_qkv.cu`` (body ``csrc/attention_fwd.cuh``): one
# kernel a call
K1 = ("attention_fwd::attention_bf16_kernel", "attention_fwd::attention_f32_kernel")
# K2, ``csrc/attention_qkv_bwd.cu``: a dq kernel, then a dk/dv kernel, a call
K2_FIRST = ("dq_bf16_kernel", "dq_f32_kernel")
K2 = K2_FIRST + ("dkdv_bf16_kernel", "dkdv_f32_kernel")


def _match(name: str, parts: Sequence[str]) -> bool:
    return any(p in name for p in parts)


def seconds_per_call(trace: Optional[Dict], names: Sequence[str],
                     first: Sequence[str]) -> Optional[float]:
    """Device seconds of the kernels named ``names`` over the calls counted
    by the kernels named ``first``; None where the trace has none."""
    if not trace:
        return None
    total = sum(s for n, s in trace["kernel_s"].items() if _match(n, names))
    calls = sum(c for n, c in trace["kernel_count"].items() if _match(n, first))
    return total / calls if calls and total > 0 else None
