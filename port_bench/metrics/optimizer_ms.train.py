"""Median device milliseconds from ``train_step``'s ``backward`` mark to its
``optimizer`` mark: the gradients' norm, the clip and Adam."""

from port_bench.metrics.readers import mark_ms


def read(ctx):
    return mark_ms(ctx, "optimizer")
