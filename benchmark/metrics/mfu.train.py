"""The step's frozen products (``counts/fusion.py``) over the traced
window's seconds, as a share of the card's dense TF32 peak."""

from benchmark.lib.readers import mfu_pct


def read(view):
    return mfu_pct(view)
