"""The model's operations (``counts/model_step.py``, each lane at its own lengths)
over the unprofiled stretch of the traced run, against the dense peak of the
configuration's compute dtype, in %."""

from port_bench.metrics.readers import mfu_pct as read  # noqa: F401
