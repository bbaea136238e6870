"""Share of the traced window in which no kernel, copy or set ran on the
card."""

from benchmark.lib.readers import idle_pct


def read(view):
    return idle_pct(view)
