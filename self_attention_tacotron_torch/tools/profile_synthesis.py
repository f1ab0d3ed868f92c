"""Where a synthesis request's time goes on the card.

    python3 -m self_attention_tacotron_torch.tools.profile_synthesis [--config ls]
        [--dtype bfloat16] [--steps N]

One configuration of ``tools/flagship.py`` at full width (``--config``: the
flagship with its trained weights, the default; ``baseline``, ``zoneout``, ``ls``,
``flagship-ls``, ``mgclf0``, ``flagship-mgclf0``, ``streaming``, ``vctk``, ``japanese``
and the others with weights made from a seed; ``forced`` has no fused decode and is
not offered) in ``--dtype`` (``compute_dtype``, float32 by
default), batch 32 (ragged source lengths up to 128) and batch 1, ``--steps``
decoder steps with the stop threshold out of reach, so that every run does the
same work. The first line names the card and its power limit. It prints JSON
lines:

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

from self_attention_tacotron_torch.synthesis import make_predict_fn
from self_attention_tacotron_torch.tools.flagship import (
    CONFIGS,
    DTYPES,
    device_busy,
    gpu_line,
    config_request,
    load_network,
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
    inputs = [torch.as_tensor(req[k], device=dev) if k in req else None
              for k in ("source", "source_lengths", "accent_type", "speaker_id")]
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for _ in range(2):
            net.encode(*inputs, generator=gen)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            net.encode(*inputs, generator=gen)
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
    gen = torch.Generator(device=dev).manual_seed(0)
    row = device_busy(lambda: predict(req, generator=gen), untraced_ms)
    if "error" not in row:
        row["launches_per_step"] = row["kernel_launches"] / steps
        row["device_busy_ms_per_step"] = row["device_busy_ms"] / steps
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=200, help="decoder steps per request")
    parser.add_argument("--config", choices=[c for c in CONFIGS if c != "forced"],
                        default="flagship")
    parser.add_argument("--dtype", choices=DTYPES, default="float32", help="compute dtype")
    args = parser.parse_args()
    dev = resolve_device("cuda")
    print(json.dumps({"card": gpu_line(), "config": args.config, "dtype": args.dtype,
                      "steps": args.steps}), flush=True)

    # no probability exceeds a threshold of 2: no lane fires, every run does the same work
    net = load_network(args.config, stop_token_threshold=2.0, compute_dtype=args.dtype)
    net_plain = load_network(args.config, stop_token_threshold=2.0, use_pallas_kernels=False,
                             compute_dtype=args.dtype)
    stepwise = {
        "sync": make_predict_fn(net, max_iters=args.steps, use_fused=False),
        "no_sync": make_predict_fn(net, max_iters=args.steps, use_fused=False, early_exit=False),
    }
    fused = {
        "exit_agreement": make_predict_fn(net, max_iters=args.steps),
        "to_the_cap": make_predict_fn(net, max_iters=args.steps, early_exit=False),
    }

    for batch, longest in ((32, 128), (1, 97)):
        req = config_request(net.hparams, np.random.default_rng(1234), batch, longest)
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
