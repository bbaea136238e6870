"""The attention kernel's share of its roofline: the least time of the
window's ``sdumc::flash_wavlm`` calls (``counts/wavlm.py attention_call``,
every layer of every batch) over the device time of its kernel, found by
name."""

from benchmark.lib.readers import roofline_pct

KERNELS = ("flash_wavlm_kernel",)


def read(view):
    return roofline_pct(view, "flash_wavlm", KERNELS)
