#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check every kernel.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. device: the card's name and power limit; no CUDA device is a failure;
2. build: every kernel of ``self_attention_tacotron_torch/csrc`` with ``nvcc``,
   one compiler process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at small
   ragged shapes and at the flagship shapes, float32 and bfloat16, with times
   by CUDA events;
4. main path: flagship synthesis at full width from the committed trained
   weights through ``convert.load_npz`` and ``make_predict_fn``, batch 1 and
   batch 32, once through the kernels and once with ``use_pallas_kernels=False``,
   same generator seed; lengths, flags and step counts must be equal, frames
   and alignments within the stated tolerances, and every kernel's launch count
   above zero; then a short request on the card against the same request on
   the CPU;
5. report: one JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device is available\n")
    sys.exit(1)

from self_attention_tacotron_torch import convert  # noqa: E402
from self_attention_tacotron_torch.hparams import HParams  # noqa: E402
from self_attention_tacotron_torch.ops import fused_attention, fused_rnn  # noqa: E402
from self_attention_tacotron_torch.synthesis import make_predict_fn  # noqa: E402
from self_attention_tacotron_torch.tools.flagship import (  # noqa: E402
    TRAINED_NPZ as NPZ,
    flagship_hparams,
    gpu_line,
    ragged_lengths,
    ragged_request,
)
from self_attention_tacotron_torch.utils import cuda_build  # noqa: E402
from self_attention_tacotron_torch.utils.platform import use_full_float32  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (dense): float32 outside the tensor cores,
# bfloat16 in them, and the device memory rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of kernel against plain version (max absolute error), with reasons:
# float32 differs only by the order of summation, over up to 256 terms and, in
# the GRU, 128 recurrent steps; bfloat16 outputs are rounded to 8 bits of
# mantissa, so one flipped rounding of a value near 1 is already 4e-3, and the
# GRU feeds such flips back through its steps.
TOL = {
    ("bigru", torch.float32): 1e-4, ("bigru", torch.bfloat16): 3e-2,
    ("mha_full", torch.float32): 2e-5, ("mha_full", torch.bfloat16): 2e-2,
}
# Kernel path against the plain path through the whole synthesis (float32). The
# two encoders differ by about 1e-6, and the autoregressive loop feeds every
# difference back: lanes that never fire their stop token run 500 steps on
# their own output, far beyond the end of the utterance, and spread apart. So
# the first EARLY_STEPS decoder steps are held tightly, the whole run loosely,
# and lengths, flags and step counts exactly.
EARLY_STEPS = 50
TOL_MAIN_EARLY = 1e-4
TOL_MAIN = 5e-2
# The card (kernel path) against the port on the CPU, 30 decoder steps at full
# width with the same injected masks: float32 sums in another order.
TOL_CPU = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def require(condition, message: str) -> None:
    if not condition:
        raise SystemExit(f"chip_smoke: {message}")


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------------------- #
# Phase 3: each kernel against its plain version
# --------------------------------------------------------------------------- #


def gru_params(rng, C, H, dtype):
    def arr(*shape, scale):
        return torch.tensor(
            rng.standard_normal(shape).astype(np.float32) * scale, device=DEV
        ).to(dtype)

    s = 1.0 / np.sqrt(C + H)
    return {
        "gates_kernel": arr(C + H, 2 * H, scale=s), "gates_bias": arr(2 * H, scale=0.1),
        "candidate_kernel": arr(C + H, H, scale=s), "candidate_bias": arr(H, scale=0.1),
    }


def check_bigru(B, S, C, H, lengths, dtype, timed: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    xs = torch.tensor(rng.standard_normal((B, S, C)).astype(np.float32), device=DEV).to(dtype)
    lens = torch.tensor(np.asarray(lengths, np.int32), device=DEV)
    pf, pb = gru_params(rng, C, H, dtype), gru_params(rng, C, H, dtype)
    got = fused_rnn.bigru(xs, lens, pf, pb, H)
    torch.cuda.synchronize()
    want = fused_rnn.bigru_reference(xs, lens, pf, pb, H)
    err = max_abs_err(got, want)
    tol = TOL[("bigru", dtype)]
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol
    rec = {
        "kernel": "bigru", "shape": {"B": B, "S": S, "C": C, "H": H},
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol, "ok": ok,
    }
    if timed:
        elem = xs.element_size()
        steps = int(np.minimum(np.asarray(lengths), S).sum())
        flops = 2.0 * steps * 2 * (C + H) * 3 * H
        nbytes = elem * (B * S * C + B * S * 2 * H + 2 * ((C + H) * 3 * H + 3 * H)) + 4 * B
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
        rec.update(
            ms=time_ms(lambda: fused_rnn.bigru(xs, lens, pf, pb, H)),
            plain_ms=time_ms(
                lambda: fused_rnn.bigru_reference(xs, lens, pf, pb, H), warmup=1, iters=2
            ),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
        )
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"bigru disagrees with its plain version: {rec}")
    return rec


def check_mha(B, T, D, H, lengths, dtype, timed: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, T, 3 * D)).astype(np.float32), device=DEV).to(dtype)
    mask = None
    if lengths is not None:
        mask = torch.arange(T, device=DEV)[None, :] < torch.tensor(lengths, device=DEV)[:, None]
    ctx, probs = fused_attention.mha_full(qkv, mask, H)
    torch.cuda.synchronize()
    want_ctx, want_probs = fused_attention.mha_full_reference(qkv, mask, H)
    err_ctx, err_probs = max_abs_err(ctx, want_ctx), max_abs_err(probs, want_probs)
    err = max(err_ctx, err_probs)
    tol = TOL[("mha_full", dtype)]
    finite = bool(torch.isfinite(ctx.float()).all()) and bool(torch.isfinite(probs).all())
    ok = finite and err <= tol
    rec = {
        "kernel": "mha_full", "shape": {"B": B, "T": T, "D": D, "H": H},
        "masked": mask is not None, "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err, "err_ctx": err_ctx, "err_probs": err_probs, "tol": tol, "ok": ok,
    }
    if timed:
        elem = qkv.element_size()
        flops = 4.0 * B * H * T * T * (D // H)
        nbytes = elem * (B * T * 3 * D + B * T * D) + 4 * B * H * T * T
        nbytes += B * T if mask is not None else 0
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
        hd = D // H
        q, k, v = (
            p.reshape(B, T, H, hd).permute(0, 2, 1, 3).contiguous() for p in qkv.split(D, dim=-1)
        )
        attn_mask = None if mask is None else mask[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rec.update(
            ms=time_ms(lambda: fused_attention.mha_full(qkv, mask, H)),
            plain_ms=time_ms(lambda: fused_attention.mha_full_reference(qkv, mask, H)),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
            # for scale only, and used nowhere in the port: the library's fused
            # attention gives the context but no probabilities, so it is not
            # the same function and is no library time for this kernel
            sdpa_context_only_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=attn_mask)),
        )
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"mha_full disagrees with its plain version: {rec}")
    return rec


def phase_kernels():
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        # the small ragged shapes of the CPU tests, and shapes off every tile size
        check_bigru(4, 12, 10, 8, [12, 7, 1, 12], dtype, timed=False)
        check_bigru(5, 9, 7, 20, [9, 1, 4, 9, 2], dtype, timed=False, seed=1)
        check_bigru(1, 33, 128, 128, [33], dtype, timed=False, seed=2)
        check_mha(3, 16, 32, 2, [16, 9, 3], dtype, timed=False)
        check_mha(3, 16, 32, 2, None, dtype, timed=False)
        check_mha(2, 37, 72, 3, [37, 5], dtype, timed=False, seed=1)
        # the flagship shapes, ragged
        lengths = ragged_lengths(np.random.default_rng(3), 32, 128)
        records[("bigru", dtype)] = check_bigru(32, 128, 128, 128, lengths, dtype, timed=True)
        records[("mha_full", dtype)] = check_mha(
            32, 128, 256, 2, lengths.tolist(), dtype, timed=True
        )
    return records


# --------------------------------------------------------------------------- #
# Phase 4: the main path
# --------------------------------------------------------------------------- #


def requests():
    rng = np.random.default_rng(1234)
    return [ragged_request(rng, batch, longest) for batch, longest in ((1, 97), (32, 128))]


def run_requests(predict, reqs, seed: int):
    outs, stats = [], []
    for i, req in enumerate(reqs):
        gen = torch.Generator(device=DEV).manual_seed(seed + i)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = predict(req, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        frames = int(out["lengths"].sum())
        stats.append({
            "batch": int(req["source"].shape[0]), "wall_s": wall,
            "num_steps": int(out["num_steps"]), "frames": frames,
            "frames_per_s": frames / wall,
            "ms_per_step": 1e3 * wall / max(int(out["num_steps"]), 1),
            "finished": int(out["finished"].sum()),
        })
        outs.append(out)
    return outs, stats


def check_output(out, req, hp: HParams) -> None:
    batch, src = req["source"].shape
    steps, r = hp.max_iters, hp.outputs_per_step
    require(out["mel"].shape == (batch, steps * r, hp.num_mels), f"mel {out['mel'].shape}")
    require(out["stop_probs"].shape == (batch, steps * r), "shape of stop_probs")
    require(
        [tuple(a.shape) for a in out["alignments"]] == [(batch, steps, src)] * 2,
        "shape of alignments",
    )
    require(
        out["encoder_sa_alignments"][0].shape == (batch, 2, src, src),
        "shape of encoder_sa_alignments",
    )
    for key in ("mel", "stop_probs"):
        require(bool(torch.isfinite(out[key]).all()), f"{key} is not finite")
    n = int(out["num_steps"])
    require(1 <= n <= steps, f"num_steps {n}")
    for align in out["alignments"]:
        sums = align[:, :n].sum(dim=-1)
        require(float((sums - 1.0).abs().max()) < 1e-4, "alignment rows do not sum to 1")
    sa = out["encoder_sa_alignments"][0].sum(dim=-1)
    require(float((sa - 1.0).abs().max()) < 1e-4, "encoder attention rows do not sum to 1")
    lengths = out["lengths"]
    require(int(lengths.min()) >= 1 and int(lengths.max()) <= n * r, "lengths out of range")


def output_errors(out, ref, steps: int, r: int):
    """Max absolute differences over the first ``steps`` decoder steps."""
    return {
        "mel": max_abs_err(out["mel"][:, : steps * r], ref["mel"][:, : steps * r]),
        "stop_probs": max_abs_err(
            out["stop_probs"][:, : steps * r], ref["stop_probs"][:, : steps * r]
        ),
        "alignments": max(
            max_abs_err(a[:, :steps], b[:, :steps])
            for a, b in zip(out["alignments"], ref["alignments"])
        ),
        "encoder_sa_alignments": max_abs_err(
            out["encoder_sa_alignments"][0], ref["encoder_sa_alignments"][0]
        ),
    }


def phase_against_cpu(steps: int = 30) -> None:
    """The card's kernel path against the port on the CPU, which the CPU tests
    hold against the JAX package: same weights, same source, same injected
    decoder prenet masks, encoder prenet dropout off, no early exit."""
    # no probability exceeds a threshold of 2: every lane runs all the steps
    hp = flagship_hparams(encoder_prenet_drop_rate=0.0, stop_token_threshold=2.0)
    rng = np.random.default_rng(77)
    req = ragged_request(rng, 2, 40)
    masks = tuple(
        rng.random((steps, 2, units)) < 1.0 - hp.decoder_prenet_drop_rate
        for units in hp.decoder_prenet_out_units
    )
    before = (fused_rnn.launch_count, fused_attention.launch_count)
    on_card = make_predict_fn(convert.load_npz(NPZ, hp), max_iters=steps)(req, prenet_masks=masks)
    torch.cuda.synchronize()
    require(
        (fused_rnn.launch_count, fused_attention.launch_count) == (before[0] + 1, before[1] + 1),
        "one request must launch each kernel once",
    )
    on_cpu = make_predict_fn(
        convert.load_npz(NPZ, hp, device="cpu"), max_iters=steps, device="cpu"
    )(req, prenet_masks=masks)
    card = {
        k: tuple(x.cpu() for x in v) if isinstance(v, tuple) else v.cpu()
        for k, v in on_card.items()
    }
    errs = output_errors(card, on_cpu, steps, hp.outputs_per_step)
    log("main_path card_vs_cpu " + json.dumps({"steps": steps, **errs, "tol": TOL_CPU}))
    if int(card["num_steps"]) != steps or not torch.equal(card["lengths"], on_cpu["lengths"]):
        raise SystemExit("the card and the CPU disagree on the steps or the lengths")
    if not max(errs.values()) <= TOL_CPU:
        raise SystemExit(f"the card and the CPU differ: {errs}")


def phase_main_path():
    use_full_float32()
    reqs = requests()
    hp = flagship_hparams()
    predict = make_predict_fn(convert.load_npz(NPZ, hp), max_iters=hp.max_iters)
    run_requests(predict, reqs[:1], seed=0)            # warm-up: cuBLAS, cuDNN, allocator

    fused_rnn.launch_count = 0
    fused_attention.launch_count = 0
    outs, stats = run_requests(predict, reqs, seed=100)
    launches = {"bigru": fused_rnn.launch_count, "mha_full": fused_attention.launch_count}
    log("main_path kernels " + json.dumps({"launches": launches, "requests": stats}))
    for name, count in launches.items():
        if count < len(reqs):
            raise SystemExit(f"the main path launched {name} {count} times in {len(reqs)} requests")
    for out, req in zip(outs, reqs):
        check_output(out, req, hp)

    hp_plain = flagship_hparams(use_pallas_kernels=False)
    predict_plain = make_predict_fn(convert.load_npz(NPZ, hp_plain), max_iters=hp.max_iters)
    before = (fused_rnn.launch_count, fused_attention.launch_count)
    outs_plain, stats_plain = run_requests(predict_plain, reqs, seed=100)
    require(
        before == (fused_rnn.launch_count, fused_attention.launch_count),
        "the plain path launched a kernel",
    )
    log("main_path plain " + json.dumps({"requests": stats_plain}))

    r = hp.outputs_per_step
    for out, ref in zip(outs, outs_plain):
        for key in ("lengths", "finished", "num_steps"):
            if not torch.equal(out[key], ref[key]):
                raise SystemExit(f"{key} differs between the kernel path and the plain path")
        whole = output_errors(out, ref, hp.max_iters, r)
        early = output_errors(out, ref, EARLY_STEPS, r)
        log("main_path agreement " + json.dumps({
            "batch": int(out["mel"].shape[0]),
            "early_steps": EARLY_STEPS, "early": early, "early_tol": TOL_MAIN_EARLY,
            "whole": whole, "whole_tol": TOL_MAIN,
        }))
        if not max(early.values()) <= TOL_MAIN_EARLY:
            raise SystemExit(f"kernel path and plain path differ early: {early}")
        if not max(whole.values()) <= TOL_MAIN:
            raise SystemExit(f"kernel path and plain path differ: {whole}")
    phase_against_cpu()
    return launches, stats


# --------------------------------------------------------------------------- #


def main() -> int:
    started = time.perf_counter()
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = cuda_build.build_all()
    log(f"build: {len(cuda_build.KERNEL_SOURCES)} kernels with nvcc in {build_s:.1f} s "
        f"-> {os.path.relpath(cuda_build.BUILD_DIR, REPO)}")

    use_full_float32()
    records = phase_kernels()
    launches, stats = phase_main_path()

    replaces = {
        "bigru": "self_attention_tacotron_tpu/ops/fused_rnn.py:101",
        "mha_full": "self_attention_tacotron_tpu/ops/fused_attention.py:84",
    }
    kernels = []
    for name in ("bigru", "mha_full"):
        rec = records[(name, torch.float32)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"self_attention_tacotron_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
            "shape": rec["shape"], "dtype": rec["dtype"],
            "bf16_ms": records[(name, torch.bfloat16)]["ms"],
            "bf16_max_abs_err": records[(name, torch.bfloat16)]["max_abs_err"],
        })
    log(f"total: {time.perf_counter() - started:.1f} s")
    log(gpu_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
