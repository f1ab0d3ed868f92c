#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check every kernel.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. device: the card's name and power limit; no CUDA device is a failure;
2. build: every kernel of ``self_attention_tacotron_torch/csrc`` with ``nvcc``,
   one compiler process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at small
   ragged shapes and at the flagship shapes, with times by CUDA events: ``bigru``
   and ``mha_full`` in float32 and bfloat16; ``fused_decode`` (the whole decode
   loop, float32) with prenet dropout 0.5 from injected masks, at narrow and
   off-tile sizes (transition agent, speaker embedding, two batch blocks, a
   prefix of 320 steps), at the flagship sizes to the step cap, and with an
   early exit whose threshold is taken from the plain run's own stop
   probabilities, where lengths, flags, step counts and the zero tail must be
   equal; the timed 500-step launch against the plain version by windows of
   steps; and a step cap beyond one block's shared memory, where the launch
   limit is 0 and ``predict`` raises; the training kernels: ``bigru_train`` (the
   BiGRU's forward kernel and the kernel of its backward's carry recursion)
   against autograd through the plain version, outputs and the gradients of the
   input and of all eight weights; ``fused_teacher`` (the teacher-forced decoder
   scan, one kernel forward and one backward) against its plain version under
   autograd, outputs and every gradient, at narrow and off-tile sizes (transition
   agent, speaker embedding, eval zoneout, train zoneout, zoneout 0) and at the
   flagship sizes over 400 steps with conditioning from the real encoder, the
   trained weights, prenet dropout and train zoneout;
4. main path: flagship synthesis at full width from the committed trained
   weights through ``convert.load_npz`` and ``make_predict_fn``, batch 1 and
   batch 32, once through the kernels (the fused decode included) and once with
   ``use_pallas_kernels=False`` (eager encoder, step-by-step decode), same
   generator seed; lengths and flags must be equal on every lane whose stop
   probabilities keep a margin from the threshold, frames and alignments within
   the stated tolerances, and every kernel's launch count above zero; then a
   short request on the card against the same request on the CPU;
5. training main path: ``Trainer.train_step`` of the flagship from the trained
   weights on a seeded batch of 32 lanes x 800 frames, three steps through the
   kernels and three with ``use_pallas_kernels=False``, same state and generator
   seed: loss parts and ``grad_norm`` must agree, every kernel of the step must
   have been launched once forward and once backward per step, the plain path
   must launch none; an evaluation step on both paths;
6. report: one JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
from self_attention_tacotron_torch.models.decoders import DecoderConditioning  # noqa: E402
from self_attention_tacotron_torch.models.models import (  # noqa: E402
    TacotronNetwork,
    tacotron_model_factory,
)
from self_attention_tacotron_torch.ops import (  # noqa: E402
    fused_attention,
    fused_decode,
    fused_rnn,
    fused_teacher,
)
from self_attention_tacotron_torch.synthesis import make_predict_fn  # noqa: E402
from self_attention_tacotron_torch.tools.flagship import (  # noqa: E402
    TRAINED_NPZ as NPZ,
    device_busy,
    flagship_hparams,
    gpu_line,
    ragged_lengths,
    ragged_request,
    training_batch,
)
from self_attention_tacotron_torch.tools.profile_training import timed_step  # noqa: E402
from self_attention_tacotron_torch.training.trainer import Trainer  # noqa: E402
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
# fused_decode against fused_decode_reference on the card (float32, TF32 off):
# the two differ only by the order of summation (sums of up to 1024 terms), but
# every step feeds its frame back, so the difference grows with the steps. The
# comparisons run FUSED_STEPS decoder steps: the eager paths of this port were
# measured 1.5e-5 apart after 50 steps and 1.4e-2 after 500.
FUSED_STEPS = 64
TOL_FUSED = 1e-4
# The same tolerance holds decoders with seeded weights, which do not spread, over
# long runs to the cap: a narrow one over FUSED_LONG_STEPS steps and one of the
# flagship's widths over the main path's 500. From step 256 on, the attention over
# the cache's prefix takes the paths of a long prefix (one slice of the head width
# per thread group, index loops that stride over the block).
# The trained model does spread: a lane that never fires feeds its own output back
# far beyond the end of its utterance, and there the plain version moved against
# itself by one part in 1e7 of the memories ends up to 0.95 apart on a few lanes
# (printed by this script as "plain version against itself"). So the timed launch,
# trained weights and 500 steps with no exit, is held against the plain version's
# run on the same masks by windows of steps, on the largest error of each lane: in
# the first two windows every lane is held (steps 64 to 256 at twice what the plain
# version moved against itself there, 2.5e-3), in the last the median lane (where a
# fault of the long-prefix paths would show on every lane) and only for a batch of
# at least FUSED_MEDIAN_LANES lanes; the largest is printed beside it.
FUSED_LONG_STEPS = 320
FUSED_WINDOWS = ((FUSED_STEPS, TOL_FUSED, "max"), (256, 5e-3, "max"), (500, 1e-3, "median"))
FUSED_MEDIAN_LANES = 8
# An early-exit threshold is placed in the widest gap of the plain run's stop
# logits; the gap must be at least this many times the largest difference between
# the kernel's and the plain version's stop logits, so that "fired" cannot differ.
FUSED_MARGIN_FACTOR = 200.0
# Kernel path against the plain path through the whole synthesis (float32). The
# two encoders differ by about 1e-6, and the autoregressive loop feeds every
# difference back: lanes that never fire their stop token run 500 steps on
# their own output, far beyond the end of the utterance, and spread apart. So
# the first EARLY_STEPS decoder steps are held tightly and the whole run loosely.
# Lengths and flags are held exactly on every lane whose stop probabilities, in
# the plain run and up to the lane's firing frame, stay MAIN_MARGIN away from the
# threshold (twice the loose tolerance); the other lanes are counted and printed.
EARLY_STEPS = 50
TOL_MAIN_EARLY = 1e-4
TOL_MAIN = 5e-2
MAIN_MARGIN = 0.1
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
# Phase 3, continued: the whole-loop decode kernel against its plain version
# --------------------------------------------------------------------------- #


def narrow_hparams(**overrides) -> HParams:
    """The narrow flagship of the CPU tests: units 32, A1/A2 = 24/8, 10 mel bins."""
    hp = HParams(
        tacotron_model="DualSourceSelfAttentionTacotronModel",
        encoder="SelfAttentionCBHGEncoder", decoder="DualSourceSelfAttentionDecoder",
        attention="forward", attention2="additive", num_symbols=30, embedding_dim=32,
        encoder_prenet_out_units=(32, 16), cbhg_out_units=32, conv_channels=16,
        max_filter_width=4, projection1_out_channels=16, projection2_out_channels=16,
        num_highway=2, self_attention_out_units=32, self_attention_num_heads=2,
        self_attention_transformer_ffn_units=64, decoder_prenet_out_units=(32, 16),
        attention_out_units=32, attention1_out_units=24, attention2_out_units=8,
        decoder_out_units=32, decoder_self_attention_out_units=32,
        decoder_self_attention_num_heads=2, num_mels=10, outputs_per_step=2,
    )
    return hp.override_from_dict(overrides)


def seeded_decoder(hp: HParams, seed: int):
    """A decoder with weights drawn from ``seed``, on the card, in eval mode."""
    torch.manual_seed(seed)
    return TacotronNetwork(hp).decoder.to(DEV).eval()


def seeded_conditioning(decoder, rng, lengths, src_len: int, speaker_units: int = 0):
    """Memories from ``rng``, keys from the decoder's own memory layers."""
    batch = len(lengths)
    memories = tuple(
        torch.tensor(rng.standard_normal((batch, src_len, e)).astype(np.float32), device=DEV)
        for e in decoder.memory_units
    )
    mask = torch.arange(src_len, device=DEV)[None, :] < torch.tensor(lengths, device=DEV)[:, None]
    speaker = None
    if speaker_units:
        speaker = torch.tensor(
            rng.standard_normal((batch, speaker_units)).astype(np.float32), device=DEV
        )
    with torch.no_grad():
        keys = decoder.compute_keys(memories)
    return DecoderConditioning(
        memories=memories, keys=keys, masks=(mask, mask), speaker_embed=speaker
    )


def seeded_masks(packed, rng, steps: int, batch: int):
    """Prenet keep-masks for every step at the decoder's own drop rate; None at rate 0."""
    if packed.keep_prob >= 1.0:
        return None
    return tuple(
        torch.tensor(rng.random((steps, batch, packed.sizes[k])) < packed.keep_prob, device=DEV)
        for k in ("P1", "P2")
    )


def stop_logits(stop_probs: torch.Tensor) -> np.ndarray:
    p = stop_probs.double().cpu().numpy()
    with np.errstate(divide="ignore"):
        return np.clip(np.log(p) - np.log1p(-p), -80.0, 30.0)


def exit_threshold(stop_probs: torch.Tensor, steps: int, r: int):
    """(threshold, gap in logits): the middle of the widest gap between the run's own
    stop logits at which every lane fires before the cap and not all at one step.
    A trained model's early stop probabilities are tiny (1e-10 to 1e-6); float32
    resolves those relatively, so only thresholds near 1 are left out."""
    logits = stop_logits(stop_probs)
    values = np.unique(logits)
    best_gap, best_mid = 0.0, None
    for lo, hi in zip(values[:-1], values[1:]):
        mid = (lo + hi) / 2
        if hi - lo <= best_gap or mid > 10.0:
            continue
        fired = logits > mid
        if not fired.any(axis=1).all():
            continue
        first_step = fired.argmax(axis=1) // r
        spread = len(set(first_step.tolist())) > 1 or len(first_step) == 1
        if first_step.max() < steps - 2 and spread:
            best_gap, best_mid = hi - lo, mid
    require(best_mid is not None, "no threshold lets every lane fire at its own step")
    return float(1.0 / (1.0 + np.exp(-best_mid))), float(best_gap)


def fused_flops_and_bytes(packed, lengths, steps: int):
    """What ``steps`` decoder steps need on these inputs: operations (products,
    the score pass and contexts over the valid positions, attention over the
    live prefix) and bytes (every input read once, every output written once; the
    K/V cache is scratch and is counted apart)."""
    z = packed.sizes
    batch, valid = len(lengths), int(np.sum(lengths))
    src_len = int(np.max(lengths))
    products = sum(
        rows * cols for name, (rows, cols) in packed.shapes.items()
        if name.endswith("_w") and (name != "ta_w" or packed.use_transition_agent)
    )
    a_tot, e_tot = z["A1"] + z["A2"], z["E1"] + z["E2"]
    per_step = batch * 2 * products + valid * (4 * a_tot + 2 * e_tot)
    attention = batch * 4 * z["SA"] * steps * (steps + 1) // 2
    flops = steps * per_step + attention
    out_row = z["R"] * z["M"] + z["R"] + 2 * src_len
    nbytes = (
        4 * packed.flat.numel() + 4 * batch * src_len * (a_tot + e_tot + 1)
        + steps * batch * (z["P1"] + z["P2"]) + 4 * batch * steps * out_row + 9 * batch
    )
    cache_bytes = batch * 2 * z["SA"] * 4 * (steps + steps * (steps + 1) // 2)
    return float(flops), float(nbytes), float(cache_bytes)


def compare_decodes(got, want, r: int):
    """Float differences over the steps both ran; lengths, flags, step count and
    the zero tail are held exactly."""
    steps = int(want.num_steps)
    exact = (
        int(got.num_steps) == steps
        and torch.equal(got.lengths, want.lengths)
        and torch.equal(got.finished, want.finished)
        and got.lengths.dtype == torch.int32 and got.finished.dtype == torch.bool
    )
    tail = sum(
        float(x[:, n:].abs().sum())
        for x, n in (
            (got.frames["mel"], steps * r), (got.stop_probs, steps * r),
            (got.alignments[0], steps), (got.alignments[1], steps),
        )
    )
    finite = all(
        bool(torch.isfinite(x).all())
        for x in (got.frames["mel"], got.stop_probs, *got.alignments)
    )
    errs = {
        "mel": max_abs_err(got.frames["mel"], want.frames["mel"]),
        "stop_probs": max_abs_err(got.stop_probs, want.stop_probs),
        "alignments": max(max_abs_err(a, b) for a, b in zip(got.alignments, want.alignments)),
        "stop_logits": float(np.abs(
            stop_logits(got.stop_probs[:, : steps * r]) - stop_logits(want.stop_probs[:, : steps * r])
        ).max()),
    }
    return errs, exact, tail == 0.0, finite


def check_fused(name, packed, cond, masks, steps, threshold, early_exit=True, slice_batch=None):
    batch, src_len = cond.memories[0].shape[:2]
    r = packed.sizes["R"]
    before = fused_decode.launch_count
    got = fused_decode.fused_decode(
        packed, cond, masks, steps, threshold, early_exit=early_exit, slice_batch=slice_batch
    )
    torch.cuda.synchronize()
    launches = fused_decode.launch_count - before
    want = fused_decode.fused_decode_reference(
        packed, cond, masks, steps, threshold, early_exit=early_exit
    )
    errs, exact, zero_tail, finite = compare_decodes(got, want, r)
    blocks = -(-batch // (slice_batch or batch))
    ok = (
        finite and exact and zero_tail and launches == blocks
        and max(errs["mel"], errs["stop_probs"], errs["alignments"]) <= TOL_FUSED
    )
    rec = {
        "kernel": "fused_decode", "case": name,
        "shape": {"B": batch, "S": src_len, "T": steps, **packed.sizes},
        "transition_agent": packed.use_transition_agent, "threshold": threshold,
        "early_exit": early_exit, "launches": launches, "num_steps": int(got.num_steps),
        "lengths": got.lengths.tolist() if batch <= 8 else None,
        "finished": int(got.finished.sum()),
        "max_abs_err": max(errs["mel"], errs["stop_probs"], errs["alignments"]), **errs,
        "tol": TOL_FUSED, "exact_lengths_flags_steps": exact, "zero_tail": zero_tail, "ok": ok,
    }
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"fused_decode disagrees with its plain version: {rec}")
    return rec, want


def timed_once(fn):
    """(result, ms by CUDA events) of one call."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def lane_errors(got, want, r: int, lo: int, hi: int) -> torch.Tensor:
    """Per lane, the largest absolute difference over decoder steps lo..hi."""
    pairs = [
        (got.frames["mel"][:, lo * r : hi * r], want.frames["mel"][:, lo * r : hi * r]),
        (got.stop_probs[:, lo * r : hi * r], want.stop_probs[:, lo * r : hi * r]),
        *((a[:, lo:hi], b[:, lo:hi]) for a, b in zip(got.alignments, want.alignments)),
    ]
    return torch.stack([(a - b).abs().flatten(1).amax(dim=1) for a, b in pairs]).amax(dim=0)


def window_errors(got, want, r: int):
    windows, lo = [], 0
    for hi, tol, held in FUSED_WINDOWS:
        errs = lane_errors(got, want, r, lo, hi)
        windows.append({
            "steps": [lo, hi], "max": float(errs.max()), "median": float(errs.median()),
            "lanes_above_2e-2": int((errs > 2e-2).sum()), "tol": tol, "held": held,
        })
        lo = hi
    return windows


def check_fused_long(name, got, want, r: int):
    """The trained model's long run to the cap against the plain version's, by
    windows of steps (see FUSED_WINDOWS)."""
    errs, exact, zero_tail, finite = compare_decodes(got, want, r)
    require(FUSED_WINDOWS[-1][0] == int(want.num_steps), "the windows must cover the run")
    windows = window_errors(got, want, r)
    batch = got.lengths.shape[0]
    ok = finite and exact and zero_tail
    for w in windows:
        if w["held"] == "median" and batch < FUSED_MEDIAN_LANES:
            w["held"] = "not held: too few lanes for a median"
        else:
            ok = ok and w[w["held"]] <= w["tol"]
    rec = {
        "kernel": "fused_decode", "case": name, "num_steps": int(got.num_steps), **errs,
        "windows": windows, "exact_lengths_flags_steps": exact, "zero_tail": zero_tail, "ok": ok,
    }
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"fused_decode disagrees with its plain version: {rec}")


def check_fused_refusal(net, hp) -> None:
    """Beyond what one block's shared memory holds, the limit is 0 and the wrapper
    and ``predict`` raise: nothing is launched and nothing else decodes instead."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    fits = fused_decode.fused_decode_max_batch(hp, hp.max_iters, 128)
    beyond = 100000
    need, have = fused_decode.block_shared_memory(
        fused_decode.pack_decoder(net.decoder).sizes, 128, beyond, DEV
    )
    limit = fused_decode.fused_decode_max_batch(hp, beyond, 128)
    lo, hi = hp.max_iters, beyond   # the largest step cap at which a block still fits
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fused_decode.fused_decode_max_batch(hp, mid, 128) else (lo, mid)
    before = launch_counts()
    raised = None
    try:
        make_predict_fn(net, max_iters=beyond)(ragged_request(np.random.default_rng(5), 1, 128))
    except RuntimeError as error:
        raised = str(error)
    log("check " + json.dumps({
        "kernel": "fused_decode", "case": "launch limit", "lanes_per_launch": fits, "sms": sms,
        "max_iters_beyond": beyond, "block_needs": need, "sm_offers": have,
        "limit_beyond": limit, "largest_max_iters_that_fits": lo, "predict_raised": raised,
    }))
    require(fits == fused_decode.LANES * sms, "the launch limit is not LANES lanes per SM")
    require(need > have and limit == 0, "a block beyond an SM must give a limit of 0")
    require(raised is not None and "shared memory" in raised,
            "predict must raise where the kernel cannot launch")
    require(launch_counts()["fused_decode"] == before["fused_decode"],
            "a refused launch was counted")


def check_fused_with_exit(name, packed, cond, rng, steps, slice_batch=None):
    """To the cap first; then at a threshold from that run's own stop probabilities,
    with the early exit and without it, where every integer and flag must be equal."""
    batch = cond.memories[0].shape[0]
    masks = seeded_masks(packed, rng, steps, batch)
    rec, want = check_fused(name + ", to the cap", packed, cond, masks, steps, 2.0,
                            slice_batch=slice_batch)
    threshold, gap = exit_threshold(want.stop_probs, steps, packed.sizes["R"])
    need = FUSED_MARGIN_FACTOR * rec["stop_logits"]
    log("check " + json.dumps({
        "kernel": "fused_decode", "case": name + ", threshold", "threshold": threshold,
        "gap_in_logits": gap, "needed": need,
    }))
    require(gap >= need, f"{name}: the widest gap between stop logits ({gap}) is under {need}")
    rec_exit, _ = check_fused(name + ", early exit", packed, cond, masks, steps, threshold)
    require(rec_exit["num_steps"] < steps and rec_exit["finished"] == batch,
            f"{name}: the threshold did not end the run early")
    rec_late, _ = check_fused(name + ", exit off", packed, cond, masks, steps, threshold,
                              early_exit=False)
    require(rec_late["num_steps"] == steps and rec_late["finished"] == batch,
            f"{name}: without the exit the run must reach the cap with every lane fired")
    return rec


def flagship_conditioning(net, req, seed: int):
    source = torch.as_tensor(req["source"], device=DEV)
    lengths = torch.as_tensor(req["source_lengths"], device=DEV)
    with torch.inference_mode():
        cond, _ = net.encode(
            source, lengths, generator=torch.Generator(device=DEV).manual_seed(seed)
        )
    return cond


def phase_fused_decode():
    flagship = convert.load_npz(NPZ, flagship_hparams())
    packed = fused_decode.pack_decoder(flagship.decoder)
    check_fused_refusal(flagship, flagship.hparams)

    # (a) narrow and off-tile sizes: B=3 S=11 as the CPU tests, B=5 (two blocks of
    # the grid, one lane in the second), odd S, transition agent, speaker embedding
    rng = np.random.default_rng(11)
    steps = 24
    for name, overrides, lengths, src_len, spk in (
        ("narrow B=3 S=11", {}, [11, 7, 4], 11, 0),
        ("narrow B=5 S=13, transition agent",
         {"attention": "forward_transition_agent"}, [13, 5, 9, 1, 12], 13, 0),
        ("narrow B=5 S=9, speaker embedding",
         {"use_speaker_embedding": True, "num_speakers": 4, "speaker_embedding_dim": 6},
         [9, 9, 3, 6, 2], 9, 6),
    ):
        decoder = seeded_decoder(narrow_hparams(**overrides), seed=len(lengths) + src_len)
        cond = seeded_conditioning(decoder, rng, lengths, src_len, spk)
        check_fused_with_exit(name, fused_decode.pack_decoder(decoder), cond, rng, steps)
    # the last decoder over a long prefix, to the cap (see FUSED_LONG_STEPS)
    narrow = fused_decode.pack_decoder(decoder)
    check_fused(f"narrow B=5 S=9, {FUSED_LONG_STEPS} steps", narrow, cond,
                seeded_masks(narrow, rng, FUSED_LONG_STEPS, 5), FUSED_LONG_STEPS, 2.0)
    # the last decoder again as two sequential batch blocks (3 + 2 lanes), to the cap
    check_fused("narrow B=5 S=9, two batch blocks", narrow, cond,
                seeded_masks(narrow, rng, steps, 5), steps, 2.0, slice_batch=3)
    # widths off every power of two, three frames a step, prenet dropout off (no masks)
    odd = seeded_decoder(narrow_hparams(
        decoder_prenet_drop_rate=0.0,
        decoder_prenet_out_units=(20, 12), attention_out_units=28, attention1_out_units=10,
        attention2_out_units=7, decoder_out_units=36, decoder_self_attention_out_units=24,
        num_mels=7, outputs_per_step=3, cbhg_out_units=20, self_attention_out_units=12,
    ), seed=5)
    cond = seeded_conditioning(odd, rng, [7, 2, 5, 7, 7, 3], 7)
    check_fused_with_exit("odd widths B=6 S=7 r=3", fused_decode.pack_decoder(odd), cond, rng, 19)

    # the flagship's widths with seeded weights, the main path's step count, to the cap
    rng = np.random.default_rng(13)
    wide = seeded_decoder(flagship_hparams(), seed=3)
    packed_wide = fused_decode.pack_decoder(wide)
    steps = flagship.hparams.max_iters
    for lengths in (ragged_lengths(rng, 32, 128).tolist(), [97]):
        cond = seeded_conditioning(wide, rng, lengths, max(lengths))
        check_fused(f"flagship widths, seeded weights, B={len(lengths)}, {steps} steps",
                    packed_wide, cond, seeded_masks(packed_wide, rng, steps, len(lengths)),
                    steps, 2.0, early_exit=False)
    del wide, packed_wide

    # (b, c) flagship sizes, conditioning from the real encoder: B=32 ragged and B=1
    rng = np.random.default_rng(12)
    records = {}
    for batch, longest in ((32, 128), (1, 97)):
        req = ragged_request(rng, batch, longest)
        cond = flagship_conditioning(flagship, req, seed=batch)
        records[batch] = check_fused_with_exit(
            f"flagship B={batch} S={longest}", packed, cond, rng, FUSED_STEPS
        )
        # time per launch at the main path's step count, no exit
        steps = flagship.hparams.max_iters
        masks = seeded_masks(packed, rng, steps, batch)
        run = lambda: fused_decode.fused_decode(  # noqa: E731
            packed, cond, masks, steps, 2.0, early_exit=False
        )
        ms = time_ms(run, warmup=1, iters=3)
        # that launch against the plain version's run, which gives the plain time
        want, plain_ms = timed_once(
            lambda: fused_decode.fused_decode_reference(packed, cond, masks, steps, 2.0, False)
        )
        check_fused_long(f"flagship B={batch}, {steps} steps", run(), want,
                         packed.sizes["R"])
        if batch == 32:
            # the yardstick of the last window: how far the plain version itself moves
            moved = dataclasses.replace(cond, memories=tuple(m * (1.0 + 1e-7) for m in cond.memories))
            log("check " + json.dumps({
                "kernel": "fused_decode",
                "case": f"flagship B={batch}, {steps} steps, plain version against itself "
                        "with the memories moved by one part in 1e7",
                "windows": window_errors(
                    fused_decode.fused_decode_reference(packed, moved, masks, steps, 2.0, False),
                    want, packed.sizes["R"]),
            }))
        flops, nbytes, cache_bytes = fused_flops_and_bytes(packed, req["source_lengths"], steps)
        t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S
        records[batch].update(
            ms=ms, ms_per_step=ms / steps, steps_timed=steps, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes, cache_prefix_bytes=cache_bytes,
        )
        log("check " + json.dumps({
            "kernel": "fused_decode", "case": f"flagship B={batch}, time",
            **{k: v for k, v in records[batch].items()
               if k in ("ms", "ms_per_step", "steps_timed", "plain_ms", "bound_ms", "bound_by",
                        "flops", "bytes", "cache_prefix_bytes")},
        }))
    return records


# --------------------------------------------------------------------------- #
# Phase 3, continued: the training kernels against their plain versions
# --------------------------------------------------------------------------- #

# bigru_train against autograd through bigru_reference, float32: the outputs as
# for ``bigru``; each gradient leaf relative to its largest entry (sums over up
# to B * S = 4096 rows in another order, through 128 recurrent steps).
TOL_BIGRU_GRAD = 1e-4
# fused_teacher against teacher_decode_reference under autograd, float32, TF32
# off. Teacher forcing feeds no output back, so values stay close over 400 steps:
# features and alignments absolute; each gradient relative to its leaf's largest
# entry (weight gradients sum over B * N = 12800 rows in another order).
TOL_TEACHER = 1e-4
TOL_TEACHER_GRAD = 1e-4
# These hold narrow decoders, the flagship's widths with seeded weights over 400
# steps, and the trained flagship over 40. The trained flagship over 400 steps of
# this batch spreads: its recurrences (LSTM states, the forward-attention
# recursion) amplify a rounding. The yardstick printed beside that case is the
# plain version against itself with the memories and keys moved by one part in
# 1e7 (measured 5e-3 on the values, 1.5e-4 on the gradients); the case is held at
# the looser tolerances below.
TOL_TEACHER_TRAINED = 1e-2
TOL_TEACHER_TRAINED_GRAD = 2e-3


def relative_errors(got, want):
    """Per name, the largest absolute difference over the leaf's largest entry."""
    return {
        name: float((got[name] - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        for name, w in want.items() if w is not None
    }


def check_bigru_train(B, S, C, H, lengths, timed: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    arr = lambda *shape: torch.tensor(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32), device=DEV)
    xs0, cot = arr(B, S, C), arr(B, S, 2 * H)
    lens = torch.tensor(np.asarray(lengths, np.int32), device=DEV)
    params = [gru_params(rng, C, H, torch.float32) for _ in range(2)]

    def run(fn):
        xs = xs0.clone().requires_grad_(True)
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
        y = fn(xs, lens, ps[0], ps[1], H)
        (y * cot).sum().backward()
        out = {"y": y.detach(), "d_xs": xs.grad}
        for direction, p in zip(("fwd", "bwd"), ps):
            out.update({f"d_{direction}_{k}": v.grad for k, v in p.items()})
        return out

    before = (fused_rnn.launch_count, fused_rnn.bwd_launch_count)
    got = run(fused_rnn.bigru_train)
    torch.cuda.synchronize()
    launches = (fused_rnn.launch_count - before[0], fused_rnn.bwd_launch_count - before[1])
    want = run(fused_rnn.bigru_reference)
    errs = relative_errors(got, want)
    y_err = max_abs_err(got["y"], want["y"])
    grad_err = max(v for k, v in errs.items() if k != "y")
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    ok = (finite and launches == (1, 1) and y_err <= TOL[("bigru", torch.float32)]
          and grad_err <= TOL_BIGRU_GRAD)
    rec = {
        "kernel": "bigru_bwd", "shape": {"B": B, "S": S, "C": C, "H": H}, "dtype": "float32",
        "launches_fwd_bwd": list(launches), "y_max_abs_err": y_err,
        "grad_max_rel_err": grad_err, "grad_rel_errs": errs, "tol_y": TOL[("bigru", torch.float32)],
        "tol_grad_rel": TOL_BIGRU_GRAD, "ok": ok,
    }
    if timed:
        # the carry kernel alone, on the operands the backward hands it
        weights = [p[k] for p in params for k in fused_rnn._PARAM_KEYS]
        rz, n, hp, _, _, wgh_t, wch_t = fused_rnn.bwd_operands(xs0, got["y"], weights, H)
        args = (cot, rz, n, hp, lens, wgh_t, wch_t)
        g_kernel = fused_rnn.bigru_bwd_carry(*args)
        g_plain = fused_rnn.bigru_bwd_carry_reference(*args)
        steps = int(np.minimum(np.asarray(lengths), S).sum())
        flops = 2.0 * steps * 2 * 3 * H * H
        nbytes = 4.0 * (B * S * 2 * H * (1 + 2 + 2) + B * S * H * 2 * 3 + 2 * 3 * H * H + B)
        t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S
        rec.update(
            max_abs_err=max(max_abs_err(a, b) for a, b in zip(g_kernel, g_plain)),
            ms=time_ms(lambda: fused_rnn.bigru_bwd_carry(*args)),
            plain_ms=time_ms(
                lambda: fused_rnn.bigru_bwd_carry_reference(*args), warmup=1, iters=2),
            train_fwd_bwd_ms=time_ms(lambda: run(fused_rnn.bigru_train), warmup=1, iters=5),
            plain_fwd_bwd_ms=time_ms(lambda: run(fused_rnn.bigru_reference), warmup=0, iters=2),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes", flops=flops, bytes=nbytes,
        )
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"bigru_train disagrees with autograd through its plain version: {rec}")
    return rec


def phase_bigru_bwd():
    check_bigru_train(4, 12, 10, 8, [12, 7, 1, 12], timed=False)
    check_bigru_train(5, 9, 7, 20, [9, 1, 4, 9, 2], timed=False, seed=1)
    check_bigru_train(1, 33, 128, 128, [33], timed=False, seed=2)
    lengths = ragged_lengths(np.random.default_rng(3), 32, 128)
    return check_bigru_train(32, 128, 128, 128, lengths, timed=True, seed=3)


def seeded_teacher_operands(rng, z, B, S, lengths, use_ta, spk, zc, zo, eval_zoneout):
    """Operands of ``teacher_decode`` at the sizes ``z`` with weights from ``rng``."""
    def arr(*shape, scale=0.3):
        return torch.tensor(
            rng.standard_normal(shape).astype(np.float32) * np.float32(scale), device=DEV)

    fan = lambda k: 1.0 / np.sqrt(k)  # noqa: E731
    A = z["A1"] + z["A2"]
    in_att = z["P2"] + spk + z["E1"] + z["E2"] + z["AU"]
    in1 = z["AU"] + z["E1"] + z["E2"] + z["DU"]
    vblk = torch.zeros(A, 2, device=DEV)
    vblk[: z["A1"], 0] = arr(z["A1"])
    vblk[z["A1"] :, 1] = arr(z["A2"])
    weights = dict(
        w_p1=arr(z["F"], z["P1"]), b_p1=arr(z["P1"]),
        w_p2=arr(z["P1"], z["P2"], scale=fan(z["P1"])), b_p2=arr(z["P2"]),
        w_attg=arr(in_att, 4 * z["AU"], scale=fan(in_att)), b_attg=arr(4 * z["AU"]),
        w_qp=arr(z["AU"], A, scale=fan(z["AU"])), vblk=vblk,
        w_ta=arr(z["E1"] + z["AU"], 1, scale=fan(z["AU"])), b_ta=arr(1),
        w_l1=arr(in1, 4 * z["DU"], scale=fan(in1)), b_l1=arr(4 * z["DU"]),
        w_l2=arr(2 * z["DU"], 4 * z["DU"], scale=fan(2 * z["DU"])), b_l2=arr(4 * z["DU"]),
    )
    lens = torch.tensor(lengths, device=DEV)
    return dict(
        weights=weights, keys=arr(B, S, A), mem1=arr(B, S, z["E1"]), mem2=arr(B, S, z["E2"]),
        spk=arr(B, spk) if spk else None,
        score_bias=torch.where(torch.arange(S, device=DEV)[None] < lens[:, None], 0.0, -1e9).float(),
        hp_like=dict(
            dual=True, use_ta=use_ta, att_units=z["AU"], att1_units=z["A1"],
            att2_units=z["A2"], dec_units=z["DU"], zoneout_cell=zc, zoneout_output=zo,
            prenet_drop_rate=0.0 if z.get("no_dropout") else 0.5, io_dtype="float32",
            src1_kind="forward", eval_zoneout=eval_zoneout,
        ),
    )


def teacher_flops_and_bytes(ops, feeds, lengths, backward: bool):
    """What one launch needs on these inputs. Operations: every product of the
    step once (the backward's are against the transposed weights; the weight
    gradients are batched products outside the kernel), the score pass over the
    valid positions (the backward recomputes it and adds its adjoint) and the
    contexts. Bytes: weights, conditioning and per-step rows read once, outputs
    written once."""
    hp_like, w = ops["hp_like"], ops["weights"]
    B, N = feeds.shape[:2]
    S = ops["keys"].shape[1]
    z = dict(P2=w["w_p2"].shape[1], SPK=0 if ops["spk"] is None else ops["spk"].shape[1],
             AU=hp_like["att_units"], A1=hp_like["att1_units"], A2=hp_like["att2_units"],
             DU=hp_like["dec_units"], E1=ops["mem1"].shape[-1], E2=ops["mem2"].shape[-1])
    A, E = z["A1"] + z["A2"], z["E1"] + z["E2"]
    core = [n for n in fused_teacher.CORE_WEIGHTS if hp_like["use_ta"] or n not in ("w_ta", "b_ta")]
    products = sum(w[n].numel() for n in core if n.startswith("w_"))
    weight_floats = sum(w[n].numel() for n in core)
    valid = int(np.sum(np.minimum(lengths, S)))
    widths = {k: v[1] for k, v in fused_teacher.row_layouts(z, S).items()}
    conditioning = B * S * (A + E + 1) + B * z["SPK"]
    outputs = B * N * (z["DU"] + 2 * S)
    if not backward:
        flops = N * (B * 2 * products + valid * (4 * A + 2 * E))
        floats = (weight_floats + B * N * z["P2"] + conditioning + outputs
                  + B * N * (widths["carry"] + widths["acts"]))
    else:
        flops = N * (B * 2 * products + valid * (10 * A + 4 * E))
        floats = (weight_floats + B * N * z["P2"] + conditioning + outputs
                  + B * N * (widths["carry"] + widths["acts"] + widths["stack"])
                  + B * S * A + B * 2 * A + B * widths["stack"] + B * z["SPK"])
    return float(flops), 4.0 * floats


def check_teacher(name, ops, feeds, prenet_masks, lengths, seed=1234, timed=False,
                  tol=TOL_TEACHER, tol_grad=TOL_TEACHER_GRAD, yardstick=False, valid_steps=None):
    """Forward values and every gradient of ``teacher_decode`` (two kernel launches)
    against ``teacher_decode_reference`` under autograd, non-zero cotangents for
    both outputs."""
    B, N = feeds.shape[:2]
    S = ops["keys"].shape[1]
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cot_f = torch.randn(B, N, ops["hp_like"]["dec_units"], device=DEV, generator=gen)
    cot_a = torch.randn(B, N, 2 * S, device=DEV, generator=gen)
    if valid_steps is not None:
        # as a loss masks the frames beyond a lane's target length
        live = torch.arange(N, device=DEV)[None, :] < torch.as_tensor(valid_steps, device=DEV)[:, None]
        cot_f, cot_a = cot_f * live[..., None], cot_a * live[..., None]

    def run(fn, with_align=True, moved=1.0):
        leaf = lambda v: None if v is None else v.detach().clone().requires_grad_(True)  # noqa: E731
        w = {k: leaf(v) for k, v in ops["weights"].items()}
        c = {k: leaf(None if ops[k] is None else ops[k] * moved)
             for k in ("keys", "mem1", "mem2", "spk")}
        f = leaf(feeds)
        (feat, align), fwd_ms = timed_once(lambda: fn(
            weights=w, keys=c["keys"], mem1=c["mem1"], mem2=c["mem2"], spk=c["spk"],
            score_bias=ops["score_bias"], feeds=f, seed=seed, hp_like=ops["hp_like"],
            prenet_masks=prenet_masks,
        ))
        loss = (feat * cot_f).sum() + ((align * cot_a).sum() if with_align else 0.0)
        _, bwd_ms = timed_once(loss.backward)
        grads = {**{k: v.grad for k, v in w.items()},
                 **{k: v.grad for k, v in c.items() if v is not None}, "feeds": f.grad}
        if not ops["hp_like"]["use_ta"]:
            grads.pop("w_ta"), grads.pop("b_ta")        # unused: no gradient, or zeros
        return feat.detach(), align.detach(), grads, (fwd_ms, bwd_ms)

    before = (fused_teacher.launch_count, fused_teacher.bwd_launch_count)
    got = run(fused_teacher.teacher_decode)
    launches = (fused_teacher.launch_count - before[0],
                fused_teacher.bwd_launch_count - before[1])
    want = run(fused_teacher.teacher_decode_reference)
    errs = relative_errors(got[2], want[2])
    value_err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    grad_abs = max(max_abs_err(got[2][k], g) for k, g in want[2].items() if g is not None)
    finite = all(bool(torch.isfinite(x).all()) for x in (got[0], got[1], *got[2].values()))
    sums = got[1].reshape(B, N, 2, S).sum(dim=-1)
    ok = (finite and launches == (1, 1) and value_err <= tol
          and max(errs.values()) <= tol_grad and float((sums - 1.0).abs().max()) < 1e-4)
    hp_like = ops["hp_like"]
    rec = {
        "kernel": "fused_teacher", "case": name,
        "shape": {"B": B, "S": S, "N": N, "F": feeds.shape[-1],
                  **{k: int(v) for k, v in hp_like.items() if k.endswith("_units")}},
        "transition_agent": hp_like["use_ta"], "speaker": ops["spk"] is not None,
        "zoneout": [hp_like["zoneout_cell"], hp_like["zoneout_output"]],
        "eval_zoneout": hp_like["eval_zoneout"], "prenet_dropout": prenet_masks is not None,
        "launches_fwd_bwd": list(launches),
        "features_max_abs_err": max_abs_err(got[0], want[0]),
        "alignments_max_abs_err": max_abs_err(got[1], want[1]), "tol": tol,
        "grad_max_rel_err": max(errs.values()), "grad_max_abs_err": grad_abs,
        "tol_grad_rel": tol_grad, "grad_rel_errs": errs,
        "largest_gradient_entry": max(float(g.abs().max()) for g in want[2].values()), "ok": ok,
    }
    if yardstick:
        moved = run(fused_teacher.teacher_decode_reference, moved=1.0 + 1e-7)
        rec["plain_against_itself_moved_by_1e-7"] = {
            "features_max_abs": max_abs_err(moved[0], want[0]),
            "alignments_max_abs": max_abs_err(moved[1], want[1]),
            "grad_max_rel": max(relative_errors(moved[2], want[2]).values()),
        }
    if timed:
        # a second, warm pass, with the cotangents a training step has (none for the alignments)
        again = run(fused_teacher.teacher_decode, with_align=False)
        kernel_ms = (fused_teacher.last_launch_ms("fwd"), fused_teacher.last_launch_ms("bwd"))
        plain = want            # the plain version's times are those of the run compared with
        for i, which in enumerate(("fwd", "bwd")):
            flops, nbytes = teacher_flops_and_bytes(ops, feeds, lengths, backward=bool(i))
            t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES_PER_S
            rec[which] = {
                "ms": kernel_ms[i], "ms_per_step": kernel_ms[i] / N,
                "wrapper_ms": again[3][i], "plain_ms": plain[3][i],
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes,
            }
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"fused_teacher disagrees with its plain version: {rec}")
    return rec


def phase_fused_teacher():
    narrow = dict(F=10, P1=12, P2=8, AU=12, A1=12, A2=6, DU=16, E1=12, E2=8)
    odd = dict(F=7, P1=20, P2=12, AU=28, A1=10, A2=7, DU=36, E1=20, E2=12)
    rng = np.random.default_rng(21)
    for name, z, lengths, steps, kw in (
        ("narrow B=3 S=11", narrow, [11, 7, 4], 6, {}),
        ("narrow B=5 S=13, transition agent, speaker embedding", narrow, [13, 5, 9, 1, 12], 20,
         dict(use_ta=True, spk=5)),
        ("narrow B=5 S=9, eval zoneout", narrow, [9, 9, 3, 6, 2], 20,
         dict(zc=0.1, zo=0.1, eval_zoneout=True)),
        ("odd widths B=6 S=7, train zoneout, transition agent", odd, [7, 2, 5, 7, 7, 3], 19,
         dict(zc=0.3, zo=0.2, use_ta=True)),
        ("odd widths B=6 S=7, zoneout 0, prenet dropout 0", dict(odd, no_dropout=True),
         [7, 2, 5, 7, 7, 3], 19, {}),
    ):
        B, S = len(lengths), max(lengths)
        ops = seeded_teacher_operands(
            rng, z, B, S, lengths, kw.get("use_ta", False), kw.get("spk", 0),
            kw.get("zc", 0.0), kw.get("zo", 0.0), kw.get("eval_zoneout", False),
        )
        feeds = torch.tensor(rng.standard_normal((B, steps, z["F"])).astype(np.float32), device=DEV)
        masks = None
        if ops["hp_like"]["prenet_drop_rate"] > 0.0:
            masks = tuple(torch.tensor(rng.random((B, steps, z[k])) < 0.5, device=DEV)
                          for k in ("P1", "P2"))
        check_teacher(name, ops, feeds, masks, lengths)

    # the flagship: trained weights, conditioning from the real encoder, the
    # training batch's frames, prenet dropout 0.5 and train zoneout 0.1 / 0.1
    hp = flagship_hparams()
    net = convert.load_npz(NPZ, hp)
    batch = training_batch(np.random.default_rng(1234), 32, 800, 128, hp.num_mels,
                           hp.outputs_per_step)
    with torch.no_grad():
        cond, _ = net.encode(
            torch.as_tensor(batch["source"], device=DEV),
            torch.as_tensor(batch["source_lengths"], device=DEV),
            generator=torch.Generator(device=DEV).manual_seed(0),
        )
        net.decoder.train()
        ops = net.decoder.teacher_operands(cond)
        feeds = net.decoder.make_teacher_feeds(torch.as_tensor(batch["mel"], device=DEV))
    total = feeds.shape[1]
    masks = tuple(torch.tensor(rng.random((32, total, u)) < 0.5, device=DEV)
                  for u in hp.decoder_prenet_out_units)
    valid_steps = batch["target_lengths"] // hp.outputs_per_step
    check_teacher(
        "flagship B=32 S=128 ragged, 40 steps, trained weights", ops,
        feeds[:, :40].contiguous(), tuple(m[:, :40].contiguous() for m in masks),
        batch["source_lengths"], valid_steps=valid_steps,
    )
    # the flagship's widths and step count with seeded weights, which do not spread
    wide = dict(F=80, P1=256, P2=128, AU=256, A1=224, A2=32, DU=256, E1=256, E2=256)
    lengths = batch["source_lengths"].tolist()
    check_teacher(
        f"flagship widths, seeded weights, B=32 S=128 ragged, {total} steps",
        seeded_teacher_operands(rng, wide, 32, 128, lengths, False, 0, 0.1, 0.1, False),
        feeds, masks, lengths, valid_steps=valid_steps,
    )
    # the trained flagship over all the steps of a training batch: the timed launch
    return check_teacher(
        f"flagship B=32 S=128 ragged, {total} steps, trained weights", ops, feeds, masks,
        batch["source_lengths"], timed=True, tol=TOL_TEACHER_TRAINED,
        tol_grad=TOL_TEACHER_TRAINED_GRAD, yardstick=True, valid_steps=valid_steps,
    )


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


def launch_counts():
    return {
        "bigru": fused_rnn.launch_count, "mha_full": fused_attention.launch_count,
        "fused_decode": fused_decode.launch_count,
    }


def phase_against_cpu(steps: int = 30) -> None:
    """The card's kernel path (fused decode included) against the port's
    step-by-step path on the CPU, which the CPU tests hold against the JAX
    package: same weights, same source, same injected decoder prenet masks,
    encoder prenet dropout off, no early exit."""
    # no probability exceeds a threshold of 2: every lane runs all the steps
    hp = flagship_hparams(encoder_prenet_drop_rate=0.0, stop_token_threshold=2.0)
    rng = np.random.default_rng(77)
    req = ragged_request(rng, 2, 40)
    masks = tuple(
        rng.random((steps, 2, units)) < 1.0 - hp.decoder_prenet_drop_rate
        for units in hp.decoder_prenet_out_units
    )
    before = launch_counts()
    on_card = make_predict_fn(convert.load_npz(NPZ, hp), max_iters=steps)(req, prenet_masks=masks)
    torch.cuda.synchronize()
    require(
        launch_counts() == {name: count + 1 for name, count in before.items()},
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


def compare_lengths(out, ref, threshold: float, r: int):
    """Lengths and flags, exactly, on the lanes whose stop probabilities in the
    plain run keep MAIN_MARGIN from the threshold up to and including the frame
    that fires; returns what was left out."""
    probs = ref["stop_probs"].cpu().numpy()
    lengths, fired = ref["lengths"].cpu().numpy(), ref["finished"].cpu().numpy()
    steps = int(ref["num_steps"])
    left_out = []
    for lane in range(probs.shape[0]):
        upto = int(lengths[lane]) if fired[lane] else steps * r
        margin = float(np.abs(probs[lane, :upto] - threshold).min())
        if margin < MAIN_MARGIN:
            left_out.append({
                "lane": lane, "margin": margin,
                "lengths": [int(out["lengths"][lane]), int(lengths[lane])],
            })
            continue
        same = bool(out["finished"][lane]) == bool(fired[lane])
        if fired[lane] or int(out["num_steps"]) == steps:   # else the cap of another run
            same = same and int(out["lengths"][lane]) == int(lengths[lane])
        if not same:
            raise SystemExit(
                f"lane {lane} (margin {margin}) differs between the kernel path and the plain "
                f"path: length {int(out['lengths'][lane])} against {int(lengths[lane])}"
            )
    if not left_out and not torch.equal(out["num_steps"], ref["num_steps"]):
        raise SystemExit("num_steps differs between the kernel path and the plain path")
    return left_out


def phase_main_path():
    use_full_float32()
    reqs = requests()
    hp = flagship_hparams()
    predict = make_predict_fn(convert.load_npz(NPZ, hp), max_iters=hp.max_iters)
    run_requests(predict, reqs[:1], seed=0)            # warm-up: cuBLAS, cuDNN, allocator

    fused_rnn.launch_count = 0
    fused_attention.launch_count = 0
    fused_decode.launch_count = 0
    outs, stats = run_requests(predict, reqs, seed=100)
    launches = launch_counts()
    log("main_path kernels " + json.dumps({"launches": launches, "requests": stats}))
    for name, count in launches.items():
        if count < len(reqs):
            raise SystemExit(f"the main path launched {name} {count} times in {len(reqs)} requests")
    for out, req in zip(outs, reqs):
        check_output(out, req, hp)

    # eager encoder and the step-by-step decode loop: no kernel at all
    hp_plain = flagship_hparams(use_pallas_kernels=False)
    predict_plain = make_predict_fn(convert.load_npz(NPZ, hp_plain), max_iters=hp.max_iters)
    before = launch_counts()
    outs_plain, stats_plain = run_requests(predict_plain, reqs, seed=100)
    require(before == launch_counts(), "the plain path launched a kernel")
    log("main_path plain " + json.dumps({"requests": stats_plain}))

    r = hp.outputs_per_step
    for out, ref in zip(outs, outs_plain):
        left_out = compare_lengths(out, ref, hp.stop_token_threshold, r)
        steps = min(int(out["num_steps"]), int(ref["num_steps"]))
        whole = output_errors(out, ref, steps, r)
        early = output_errors(out, ref, min(EARLY_STEPS, steps), r)
        log("main_path agreement " + json.dumps({
            "batch": int(out["mel"].shape[0]),
            "num_steps": [int(out["num_steps"]), int(ref["num_steps"])],
            "lanes_left_out_of_the_exact_comparison": left_out, "margin": MAIN_MARGIN,
            "early_steps": EARLY_STEPS, "early": early, "early_tol": TOL_MAIN_EARLY,
            "whole": whole, "whole_tol": TOL_MAIN,
        }))
        if not max(early.values()) <= TOL_MAIN_EARLY:
            raise SystemExit(f"kernel path and plain path differ early: {early}")
        if not max(whole.values()) <= TOL_MAIN:
            raise SystemExit(f"kernel path and plain path differ: {whole}")
    phase_against_cpu()
    return launches, stats, stats_plain


# --------------------------------------------------------------------------- #
# Phase 5: the training main path
# --------------------------------------------------------------------------- #

TRAIN_STEPS = 3
# Kernel path against the all-plain path, same state, batch and generator seed (so
# the same dropout and zoneout masks), float32.
# From freshly initialised weights (drawn from a seed) the gradients are well
# conditioned: the loss parts absolute, grad_norm and every gradient leaf (relative
# to the leaf's largest entry) are held after one step.
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_NORM_REL = 1e-3
TOL_TRAIN_LEAF_REL = 1e-3
# From the trained weights on this batch (random symbol ids, not text) they are not:
# the gradients of the encoder's leaves are small sums of large terms, and the
# plain path against itself with the embedding moved by one part in 1e7 moves them
# by more than half (printed as the yardstick; in float64 the same move changes them
# by about one part in a hundred). So there the first step's loss parts are held
# tightly, grad_norm only to a factor, and the later steps' losses loosely: after
# an update the paths drift, since Adam moves every weight by about the learning
# rate in the direction of its gradient's sign.
TOL_TRAINED_NORM_REL = 0.5
TOL_TRAINED_LATER = 2e-2
TOL_EVAL = 1e-4


def training_counts():
    return {
        "bigru": fused_rnn.launch_count, "bigru_bwd": fused_rnn.bwd_launch_count,
        "fused_teacher_fwd": fused_teacher.launch_count,
        "fused_teacher_bwd": fused_teacher.bwd_launch_count,
        "mha_full": fused_attention.launch_count, "fused_decode": fused_decode.launch_count,
    }


def reset_training_counts():
    fused_rnn.launch_count = fused_rnn.bwd_launch_count = 0
    fused_teacher.launch_count = fused_teacher.bwd_launch_count = 0
    fused_attention.launch_count = fused_decode.launch_count = 0


def trained_network(hp, moved: float = 1.0):
    net = convert.load_npz(NPZ, hp)
    if moved != 1.0:
        with torch.no_grad():
            for p in net.embedding.parameters():
                p.mul_(moved)
    return net


def seeded_network(hp):
    torch.manual_seed(7)
    return tacotron_model_factory(hp).network(is_training=True)


def run_training(path: str, batch, overrides, make_net, steps: int, measure: bool,
                 trace: bool = False):
    """``steps`` updates from ``make_net(hp)`` with the launch counts read around
    them. ``measure``: a warm-up on a state of its own and an evaluation step
    first; ``trace``: one more step under ``torch.profiler`` after."""
    hp = flagship_hparams(**overrides)
    trainer = Trainer(tacotron_model_factory(hp))
    eval_losses, eval_counts = {}, {}
    if measure:
        warm = trainer.init_state(make_net(hp))
        trainer.train_step(warm, batch, torch.Generator(device=DEV).manual_seed(1))
        del warm
    state = trainer.init_state(make_net(hp))
    if measure:
        reset_training_counts()
        losses, _ = trainer.eval_step(state, batch, torch.Generator(device=DEV).manual_seed(2))
        eval_losses, eval_counts = {k: float(v) for k, v in losses.items()}, training_counts()
    start = {k: v.detach().clone() for k, v in state.net.named_parameters()}

    reset_training_counts()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(4321)
    frames = int(batch["target_lengths"].sum())
    metrics, rows, first_grads = [], [], None
    for _ in range(steps):
        state, m, row = timed_step(trainer, state, batch, gen)
        if first_grads is None:
            first_grads = {k: p.grad.detach().clone() for k, p in state.net.named_parameters()}
        metrics.append({k: float(v) for k, v in m.items()})
        rows.append({**row, "frames_per_s": 1e3 * frames / row["wall_ms"]})
    counts = training_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(all(np.isfinite(v) for m in metrics for v in m.values()), f"{path}: a metric is not finite")
    moved = 0
    for name, p in state.net.named_parameters():
        require(bool(torch.isfinite(p).all()), f"{path}: {name} is not finite after training")
        moved += bool((p != start[name]).any())
    require(moved == len(start), f"{path}: only {moved} of {len(start)} parameters changed")
    require(state.step == steps, "the state must count the steps")
    busy = None
    if trace:
        busy = device_busy(lambda: trainer.train_step(state, batch, gen),
                           sum(r["wall_ms"] for r in rows[1:]) / (steps - 1), top=6)
    log(f"training {path} " + json.dumps({
        "card": gpu_line(), "batch": int(batch["mel"].shape[0]),
        "frames_per_lane": int(batch["mel"].shape[1]), "valid_frames": frames,
        "launches": counts, "steps": rows, "metrics": metrics, "eval": eval_losses,
        "eval_launches": eval_counts, "max_memory_allocated_gb": peak_gb, "device": busy,
    }))
    return {"metrics": metrics, "rows": rows, "counts": counts, "peak_gb": peak_gb,
            "first_grads": first_grads, "eval": eval_losses, "eval_counts": eval_counts,
            "device": busy}


def first_step_agreement(a, b):
    """Loss parts (absolute), grad_norm and every gradient leaf (relative) of the
    first step of two runs."""
    ma, mb = a["metrics"][0], b["metrics"][0]
    require(set(ma) == set(mb), "the two paths report different metrics")
    leaves = relative_errors(a["first_grads"], b["first_grads"])
    worst = sorted(leaves.items(), key=lambda kv: -kv[1])[:4]
    return {
        "loss_parts_abs": {k: abs(ma[k] - mb[k]) for k in ma if k != "grad_norm"},
        "grad_norm": [ma["grad_norm"], mb["grad_norm"]],
        "grad_norm_rel": abs(ma["grad_norm"] - mb["grad_norm"]) / mb["grad_norm"],
        "gradient_leaves_max_rel_err": worst[0][1],
        "gradient_leaves_median_rel_err": float(np.median(list(leaves.values()))),
        "worst_gradient_leaves": worst,
    }


def phase_training():
    hp = flagship_hparams()
    batch = training_batch(np.random.default_rng(1234), 32, 800, 128, hp.num_mels,
                           hp.outputs_per_step)
    one_step = {"bigru": 1, "bigru_bwd": 1, "fused_teacher_fwd": 1, "fused_teacher_bwd": 1,
                "mha_full": 0, "fused_decode": 0}
    plain_hp = {"use_pallas_kernels": False}

    # (a) one step from freshly initialised weights at full width: every gradient leaf
    seeded = run_training("kernels, seeded weights", batch, {}, seeded_network, 1, False)
    require(seeded["counts"] == one_step, f"one step launched {seeded['counts']}")
    seeded_plain = run_training("plain, seeded weights", batch, plain_hp, seeded_network, 1, False)
    row = first_step_agreement(seeded, seeded_plain)
    log("training agreement, seeded weights " + json.dumps({
        **row, "tol_loss": TOL_TRAIN_LOSS, "tol_grad_norm_rel": TOL_TRAIN_NORM_REL,
        "tol_leaf_rel": TOL_TRAIN_LEAF_REL,
    }))
    if not (max(row["loss_parts_abs"].values()) <= TOL_TRAIN_LOSS
            and row["grad_norm_rel"] <= TOL_TRAIN_NORM_REL
            and row["gradient_leaves_max_rel_err"] <= TOL_TRAIN_LEAF_REL):
        raise SystemExit(f"kernel path and plain path differ from seeded weights: {row}")
    del seeded, seeded_plain
    torch.cuda.empty_cache()

    # (b) the main path: three steps from the trained weights
    kernels = run_training("kernels", batch, {}, trained_network, TRAIN_STEPS, True, trace=True)
    expected = {k: TRAIN_STEPS * v for k, v in one_step.items()}
    require(kernels["counts"] == expected,
            f"{TRAIN_STEPS} training steps launched {kernels['counts']}, expected {expected}")
    require(kernels["eval_counts"] == {**one_step, "bigru_bwd": 0, "fused_teacher_bwd": 0,
                                       "mha_full": 1},
            f"an evaluation step launched {kernels['eval_counts']}")
    torch.cuda.empty_cache()
    plain = run_training("plain", batch, plain_hp, trained_network, TRAIN_STEPS, True)
    require(all(v == 0 for v in plain["counts"].values()), "the plain path launched a kernel")
    require(all(v == 0 for v in plain["eval_counts"].values()), "the plain path launched a kernel")
    nudged = run_training("plain, embedding moved by 1e-7", batch, plain_hp,
                          lambda hp: trained_network(hp, 1.0 + 1e-7), 1, False)

    first = first_step_agreement(kernels, plain)
    later = [
        {"step": i + 1, "loss_parts_abs": {k: abs(a[k] - b[k]) for k in a if k != "grad_norm"},
         "loss": [a["loss"], b["loss"]], "grad_norm": [a["grad_norm"], b["grad_norm"]]}
        for i, (a, b) in enumerate(zip(kernels["metrics"], plain["metrics"])) if i > 0
    ]
    eval_diffs = {k: abs(v - plain["eval"][k]) for k, v in kernels["eval"].items()}
    log("training agreement " + json.dumps({
        "first_step": first, "tol_loss": TOL_TRAIN_LOSS,
        "tol_grad_norm_rel": TOL_TRAINED_NORM_REL,
        "yardstick_plain_against_itself": first_step_agreement(nudged, plain),
        "later_steps": later, "tol_later": TOL_TRAINED_LATER,
        "eval_loss_parts_abs": eval_diffs, "tol_eval": TOL_EVAL,
    }))
    if not max(first["loss_parts_abs"].values()) <= TOL_TRAIN_LOSS:
        raise SystemExit(f"kernel path and plain path differ in the first step's losses: {first}")
    if not first["grad_norm_rel"] <= TOL_TRAINED_NORM_REL:
        raise SystemExit(f"kernel path and plain path differ in grad_norm: {first}")
    for row in later:
        if not max(row["loss_parts_abs"].values()) <= TOL_TRAINED_LATER:
            raise SystemExit(f"kernel path and plain path differ in the losses: {row}")
    if not max(eval_diffs.values()) <= TOL_EVAL:
        raise SystemExit(f"kernel path and plain path differ in the evaluation step: {eval_diffs}")
    return kernels, plain


def main() -> int:
    started = time.perf_counter()
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = cuda_build.build_all()
    log(f"build: {len(cuda_build.KERNEL_SOURCES)} kernels with nvcc in {build_s:.1f} s "
        f"-> {os.path.relpath(cuda_build.BUILD_DIR, REPO)}")

    use_full_float32()

    def timed_phase(phase):
        begin = time.perf_counter()
        result = phase()
        log(f"phase {phase.__name__}: {time.perf_counter() - begin:.1f} s")
        return result

    records = timed_phase(phase_kernels)
    fused = timed_phase(phase_fused_decode)
    bigru_bwd = timed_phase(phase_bigru_bwd)
    teacher = timed_phase(phase_fused_teacher)
    launches, stats, stats_plain = timed_phase(phase_main_path)
    train, train_plain = timed_phase(phase_training)

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
    # the BiGRU's forward kernel is also the primal of the training function
    kernels[0].update(
        also_replaces="self_attention_tacotron_tpu/ops/fused_rnn.py:216",
        training_launches=train["counts"]["bigru"],
    )
    # the whole loop in one launch at the main path's shapes: flagship, B=32, T=500.
    # No single PyTorch call computes a decode loop, so there is no library time;
    # the step-by-step path's wall time for the batch-32 request stands beside it.
    rec = fused[32]
    kernels.append({
        "name": "fused_decode", "route": "cuda",
        "source": "self_attention_tacotron_torch/csrc/fused_decode.cu",
        "replaces": "self_attention_tacotron_tpu/ops/fused_decode.py:787",
        "launches": launches["fused_decode"], "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        "shape": rec["shape"] | {"T": rec["steps_timed"]}, "dtype": "float32",
        "ms_per_step": rec["ms_per_step"], "compared_over_steps": FUSED_STEPS,
        "batch1_ms": fused[1]["ms"], "batch1_ms_per_step": fused[1]["ms_per_step"],
        "batch1_bound_ms": fused[1]["bound_ms"], "batch1_plain_ms": fused[1]["plain_ms"],
        "step_by_step_request_ms": 1e3 * stats_plain[1]["wall_s"],
        "step_by_step_ms_per_step": stats_plain[1]["ms_per_step"],
        "fused_request_ms": 1e3 * stats[1]["wall_s"],
    })
    # The training kernels: launches are those of the three training steps. No single
    # PyTorch call computes any of them (``torch.nn.GRU`` has another candidate, and
    # nothing computes a teacher-forced attention decoder), so there is no library
    # time; the all-plain path's training step stands beside the kernel path's.
    step_ms = {
        "train_step_ms": min(r["step_ms"] for r in train["rows"]),
        "plain_train_step_ms": min(r["step_ms"] for r in train_plain["rows"]),
    }
    kernels.append({
        "name": "bigru_bwd", "route": "cuda",
        "source": "self_attention_tacotron_torch/csrc/bigru_bwd.cu",
        "replaces": "self_attention_tacotron_tpu/ops/fused_rnn.py:293",
        "launches": train["counts"]["bigru_bwd"], "max_abs_err": bigru_bwd["max_abs_err"],
        "ms": bigru_bwd["ms"], "plain_ms": bigru_bwd["plain_ms"],
        "bound_ms": bigru_bwd["bound_ms"], "bound_by": bigru_bwd["bound_by"],
        "library_ms": None, "shape": bigru_bwd["shape"], "dtype": "float32",
        "grad_max_rel_err": bigru_bwd["grad_max_rel_err"],
        "train_fwd_bwd_ms": bigru_bwd["train_fwd_bwd_ms"],
        "plain_fwd_bwd_ms": bigru_bwd["plain_fwd_bwd_ms"], **step_ms,
    })
    for which, line, err in (
        ("fwd", 1219, max(teacher["features_max_abs_err"], teacher["alignments_max_abs_err"])),
        ("bwd", 1310, teacher["grad_max_abs_err"]),
    ):
        kernels.append({
            "name": f"fused_teacher_{which}", "route": "cuda",
            "source": "self_attention_tacotron_torch/csrc/fused_teacher.cu",
            "replaces": f"self_attention_tacotron_tpu/ops/fused_teacher.py:{line}",
            "launches": train["counts"][f"fused_teacher_{which}"], "max_abs_err": err,
            "ms": teacher[which]["ms"], "plain_ms": teacher[which]["plain_ms"],
            "bound_ms": teacher[which]["bound_ms"], "bound_by": teacher[which]["bound_by"],
            "library_ms": None, "shape": teacher["shape"], "dtype": "float32",
            "ms_per_step": teacher[which]["ms_per_step"],
            "wrapper_ms": teacher[which]["wrapper_ms"],
            "grad_max_rel_err": teacher["grad_max_rel_err"], **step_ms,
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
