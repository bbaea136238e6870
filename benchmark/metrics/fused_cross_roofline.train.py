"""The fusion kernel's share of its roofline: the least time of the
window's ``sdumc::fused_cross`` calls (``counts/fusion.py kernel_calls``)
over the device time of the kernels it launches, found by name."""

from benchmark.lib.readers import roofline_pct

KERNELS = ("split_w_kernel", "cross_partial_kernel", "cross_combine_kernel")


def read(view):
    return roofline_pct(view, "fused_cross", KERNELS)
