"""Where a synthesis request's time goes on the card.

    python3 -m self_attention_tacotron_torch.tools.profile_synthesis

Flagship at full width, trained weights, batch 32 (ragged source lengths up to
128) and batch 1, ``max_iters`` decoder steps with the stop threshold out of
reach, so that every run does the same work. It prints JSON lines:

* ``encoder``: time of ``encode`` by CUDA events, kernel path and plain path;
* ``decode``: wall time per decoder step with and without the early exit's host
  synchronisation, in turns (sync, no sync, no sync, sync);
* ``device``: from ``torch.profiler`` over one request: kernels launched per
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
    with_sync = make_predict_fn(net, max_iters=args.steps)
    no_sync = make_predict_fn(net, max_iters=args.steps, early_exit=False)

    for batch, longest in ((32, 128), (1, 97)):
        req = ragged_request(np.random.default_rng(1234), batch, longest)
        print(json.dumps({
            "encoder": {"batch": batch, "kernels_ms": encoder_ms(net, req, dev),
                        "plain_ms": encoder_ms(net_plain, req, dev)}
        }), flush=True)
        wall_per_step(with_sync, req, args.steps, dev)      # warm-up
        turns = [("sync", with_sync), ("no_sync", no_sync), ("no_sync", no_sync),
                 ("sync", with_sync)]
        times = {"sync": [], "no_sync": []}
        for name, predict in turns:
            times[name].append(wall_per_step(predict, req, args.steps, dev))
        print(json.dumps({"decode": {"batch": batch, "ms_per_step": times}}), flush=True)

        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            with_sync(req, generator=gen)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
        rows = [
            (e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        if not rows:
            print(json.dumps({"device": {"batch": batch, "error": "no device time in the trace"}}),
                  flush=True)
            continue
        busy_ms = sum(r[2] for r in rows)
        launches = sum(r[1] for r in rows)
        # the tracer slows the host down, so the share is taken against the
        # untraced wall time of the same request
        untraced_ms = args.steps * sum(times["sync"]) / len(times["sync"])
        top = sorted(rows, key=lambda r: -r[2])[:8]
        print(json.dumps({
            "device": {
                "batch": batch, "traced_wall_ms": wall_ms, "untraced_wall_ms": untraced_ms,
                "device_busy_ms": busy_ms,
                "device_busy_share_of_untraced_wall": busy_ms / untraced_ms,
                "kernel_launches": launches,
                "launches_per_step": launches / args.steps,
                "device_busy_ms_per_step": busy_ms / args.steps,
                "top_kernels": [
                    {"name": k[:80], "count": c, "device_ms": t} for k, c, t in top
                ],
            }
        }), flush=True)


if __name__ == "__main__":
    main()
