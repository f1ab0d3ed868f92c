"""Share of the window profiled for the device's activity alone (no host
operations recorded) in which no operation runs on the card (the union of the
trace's device intervals), in %."""

from port_bench.metrics.readers import idle_pct as read  # noqa: F401
