"""``fused_decode``: the least time of the profiled requests' decode
(``counts/fused_decode.py``) over the kernel's device time in the trace, in %."""

from port_bench.metrics.readers import decode_roofline as read  # noqa: F401
