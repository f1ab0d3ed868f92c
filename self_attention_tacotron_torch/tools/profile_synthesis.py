"""Where a synthesis request's time goes on the card.

    python3 -m self_attention_tacotron_torch.tools.profile_synthesis

Flagship at full width, trained weights, batch 32 (ragged source lengths up to
128) and batch 1, ``max_iters`` decoder steps with the stop threshold out of
reach, so that every run does the same work. It prints JSON lines:

* ``encoder``: time of ``encode`` by CUDA events, kernel path and plain path;
* ``decode``: time per decoder step of a whole request, in turns (a, b, b, a):
  the step-by-step loop with and without the early exit's host synchronisation
  (host clock), and the fused decode kernel with the exit agreement and without
  (host clock and CUDA events);
* ``device``, once for the step-by-step path and once for the fused path: from
  ``torch.profiler`` over one request, kernels launched per request and per
  decoder step, device-busy time per step and its share of the same request's
  untraced wall time (encoder included in both), and the kernels that take most
  device time.

Needs one CUDA device; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.synthesis import make_predict_fn
from self_attention_tacotron_torch.tools.flagship import (
    TRAINED_NPZ,
    flagship_hparams,
    gpu_line,
    ragged_request,
)
from self_attention_tacotron_torch.utils.platform import resolve_device


def wall_per_step(predict, req, steps: int, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = predict(req, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if int(out["num_steps"]) != steps:
        raise RuntimeError(f"the request ran {int(out['num_steps'])} steps, not {steps}")
    return 1e3 * wall / steps


def encoder_ms(net, req, dev, iters: int = 10) -> float:
    source = torch.as_tensor(req["source"], device=dev)
    lengths = torch.as_tensor(req["source_lengths"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for _ in range(2):
            net.encode(source, lengths, generator=gen)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            net.encode(source, lengths, generator=gen)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def events_per_step(predict, req, steps: int, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    predict(req, generator=gen)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def device_row(predict, req, steps: int, untraced_ms: float, dev):
    """One traced request: launches, device-busy time and its share of ``untraced_ms``."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        predict(req, generator=gen)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start)
    rows = [
        (e.key, e.count, e.device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not rows:
        return {"error": "no device time in the trace"}
    busy_ms = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    top = sorted(rows, key=lambda r: -r[2])[:8]
    # the tracer slows the host down, so the share is taken against the
    # untraced wall time of the same request
    return {
        "traced_wall_ms": wall_ms, "untraced_wall_ms": untraced_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share_of_untraced_wall": busy_ms / untraced_ms,
        "kernel_launches": launches,
        "launches_per_step": launches / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "top_kernels": [{"name": k[:80], "count": c, "device_ms": t} for k, c, t in top],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=200, help="decoder steps per request")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    print(json.dumps({"card": gpu_line(), "steps": args.steps}), flush=True)

    # no probability exceeds a threshold of 2: no lane fires, every run does the same work
    net = convert.load_npz(TRAINED_NPZ, flagship_hparams(stop_token_threshold=2.0))
    net_plain = convert.load_npz(
        TRAINED_NPZ, flagship_hparams(stop_token_threshold=2.0, use_pallas_kernels=False)
    )
    stepwise = {
        "sync": make_predict_fn(net, max_iters=args.steps, use_fused=False),
        "no_sync": make_predict_fn(net, max_iters=args.steps, use_fused=False, early_exit=False),
    }
    fused = {
        "exit_agreement": make_predict_fn(net, max_iters=args.steps),
        "to_the_cap": make_predict_fn(net, max_iters=args.steps, early_exit=False),
    }

    for batch, longest in ((32, 128), (1, 97)):
        req = ragged_request(np.random.default_rng(1234), batch, longest)
        print(json.dumps({
            "encoder": {"batch": batch, "kernels_ms": encoder_ms(net, req, dev),
                        "plain_ms": encoder_ms(net_plain, req, dev)}
        }), flush=True)
        decode = {"batch": batch}
        for label, pair in (("step_by_step", stepwise), ("fused", fused)):
            (a, first), (b, second) = pair.items()
            wall_per_step(first, req, args.steps, dev)      # warm-up
            times = {a: [], b: []}
            for name, predict in ((a, first), (b, second), (b, second), (a, first)):
                times[name].append(wall_per_step(predict, req, args.steps, dev))
            decode[label] = {"ms_per_step": times}
        decode["fused"]["ms_per_step_by_cuda_events"] = [
            events_per_step(fused["exit_agreement"], req, args.steps, dev) for _ in range(2)
        ]
        print(json.dumps({"decode": decode}), flush=True)

        for label, predict, times in (
            ("step_by_step", stepwise["sync"], decode["step_by_step"]["ms_per_step"]["sync"]),
            ("fused", fused["exit_agreement"], decode["fused"]["ms_per_step"]["exit_agreement"]),
        ):
            untraced_ms = args.steps * sum(times) / len(times)
            row = device_row(predict, req, args.steps, untraced_ms, dev)
            print(json.dumps({"device": {"batch": batch, "path": label, **row}}), flush=True)


if __name__ == "__main__":
    main()
