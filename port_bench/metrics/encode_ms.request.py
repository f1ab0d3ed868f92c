"""Median host milliseconds of ``TacotronNetwork.encode`` on the cell's requests,
each call ending in ``synchronize()``."""

from port_bench.metrics.readers import median


def read(ctx):
    return median(ctx.encode_ms)
