"""``fused_teacher_fwd`` and ``_bwd`` together: the least time of the profiled
steps' recurrent region (``counts/fused_teacher.py``) over the kernels' device
time in the trace, in %."""

from port_bench.metrics.readers import teacher_roofline as read  # noqa: F401
