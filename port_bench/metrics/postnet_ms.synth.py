"""Median device milliseconds (CUDA events) of ``TacotronNetwork.postnet_apply``
on served requests' decoded mel; nothing without postnets."""

from port_bench.metrics.readers import median


def read(ctx):
    return median(ctx.postnet_ms)
