"""The device's busy time in a ``torch.profiler`` trace of the card."""
from __future__ import annotations


def kernel_busy(prof):
    """Device ms with a kernel running on any stream (the union of the
    kernel intervals), the sum of kernel times, and the kernel count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e3, sum(b - a for a, b in spans) / 1e3, len(spans)
