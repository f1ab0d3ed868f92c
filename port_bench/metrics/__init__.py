"""Per-layer readers: ``<name>.py`` has ``read(ctx)`` over a traced run and
returns a number, or None where it finds nothing to read. ``ctx``: ``hp``,
``dtype``, ``trace`` (``port_bench.trace.reduce_events``), ``plain`` (the
unprofiled stretch: ``seconds`` and each request's or step's ``lanes``),
``profiled`` (the ``lanes`` of the stretch profiled for the device's activity),
and what the cell's driver samples after the trace: ``encode_ms``,
``postnet_ms``, ``marks`` (per step ``forward``, ``backward``, ``optimizer``
ms)."""
