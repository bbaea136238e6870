"""WavLM's frozen products to the tap (``counts/wavlm.py``) of the clips
returned in the traced window, over its seconds, as a share of the card's
dense TF32 peak."""

from benchmark.lib.readers import mfu_pct


def read(view):
    return mfu_pct(view)
