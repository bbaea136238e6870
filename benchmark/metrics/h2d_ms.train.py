"""Device milliseconds per step of host-to-device copies (``Memcpy HtoD``
in the trace): ``batch_to_device_dict``'s copies of the batch."""

from benchmark.lib.readers import h2d_ms_per_step


def read(view):
    return h2d_ms_per_step(view)
