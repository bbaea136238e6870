"""Host milliseconds per step that the loop waits in ``next()`` on the
program's BatchIterator (the span ``data_wait``, window total over steps)."""

from benchmark.lib.readers import span_ms_per_step


def read(view):
    return span_ms_per_step(view, "data_wait")
