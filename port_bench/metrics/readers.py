"""What the per-layer readers share."""

from __future__ import annotations

import statistics

from port_bench import trace
from port_bench.counts import fused_decode, fused_teacher, model_step
from port_bench.counts.peaks import PEAK_FLOPS, least_seconds


def idle_pct(ctx):
    t = ctx.trace
    if t["window_s"] <= 0 or not t["device"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(ctx):
    """The model's operations over the unprofiled stretch, against the dense peak
    of the configuration's compute dtype."""
    count = model_step.training if ctx.kind == "training" else model_step.synthesis
    flops = sum(count(ctx.hp, lanes) for lanes in ctx.plain["lanes"])
    if not ctx.plain["seconds"]:
        return None
    return 100.0 * flops / (ctx.plain["seconds"] * PEAK_FLOPS[ctx.dtype])


def roofline_pct(ctx, counter, *names):
    """The least time of the profiled stretch's work over the kernels' device time."""
    device_s = trace.kernel_seconds(ctx.trace, *names)
    if device_s <= 0:
        return None
    least = sum(least_seconds(*counter(ctx.hp, lanes), ctx.dtype) for lanes in ctx.profiled["lanes"])
    return 100.0 * least / device_s


def decode_roofline(ctx):
    return roofline_pct(ctx, fused_decode.flops_and_bytes, "fused_decode")


def teacher_roofline(ctx):
    return roofline_pct(ctx, fused_teacher.flops_and_bytes, "teacher_fwd_kernel",
                        "teacher_bwd_kernel")


def median(values):
    return statistics.median(values) if values else None


def mark_ms(ctx, name):
    return median([m[name] for m in ctx.marks if name in m])
