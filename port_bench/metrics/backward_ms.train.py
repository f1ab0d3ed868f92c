"""Median device milliseconds from ``train_step``'s ``forward`` mark to its
``backward`` mark: the backward pass."""

from port_bench.metrics.readers import mark_ms


def read(ctx):
    return mark_ms(ctx, "backward")
