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
   loop) in float32 with prenet dropout 0.5 from injected masks, at narrow and
   off-tile sizes (transition agent, speaker embedding, two batch blocks, a
   prefix of 320 steps), at the flagship sizes to the step cap, and with an
   early exit whose threshold is taken from the plain run's own stop
   probabilities, where lengths, flags, step counts and the zero tail must be
   equal; the timed 500-step launch against the plain version by windows of
   steps; and the flagship at a step cap of 2500 (beyond the 1872 that one
   block's shared memory held before the self-attention was tiled), B=32 and
   B=1, one launch each, the block's shared memory the same as at 500 steps,
   held by windows of steps; ``fused_decode``'s bfloat16 branch against its
   bfloat16 plain version, every pair of flags at narrow and off-tile sizes with
   early exits, the flagship from its trained weights, B=32 and B=1, timed over
   500 steps and held by windows, and the two specialisations no configuration
   runs timed at the flagship's widths in both io types; the training kernels:
   ``bigru_train`` (the
   BiGRU's forward kernel and the kernel of its backward's carry recursion)
   against autograd through the plain version, outputs and the gradients of the
   input and of all eight weights, and in bfloat16 against the same function
   with its kernels' plain versions, each output and leaf within three quarters
   of the plain version's own bfloat16-against-float32 gap in ||delta|| / ||ref||
   and the median leaf within a quarter; ``fused_teacher`` (the
   teacher-forced decoder scan, one kernel forward and one backward) against its
   plain version under autograd, outputs and every gradient, at narrow and
   off-tile sizes (transition agent, speaker embedding, eval zoneout, train
   zoneout, zoneout 0) and at the flagship sizes over 400 steps with conditioning
   from the real encoder, the trained weights, prenet dropout and train zoneout;
   and its bfloat16 instantiations, narrow and at the flagship's widths from
   seeded weights over 400 steps, held as ``bigru_train``'s; every full-width
   case timed, with its bound at the rate of its io type;
   ``bilstm`` (ZoneoutEncoderV1's LSTM) in float32 and bfloat16 at narrow
   ragged shapes and at full width; the baseline family's specialisations:
   ``fused_decode`` with one source or without self-attention (the three pairs
   of flags the flagship does not launch) at narrow sizes with early exits, the
   baseline at full width (B=32 and B=1, 500 steps, timed, and with an early
   exit) and at the step cap of 2500;
   ``fused_teacher`` with one source, narrow and at full width over 400 steps, in
   float32 and in bfloat16;
4. main path: flagship synthesis at full width from the committed trained
   weights through ``convert.load_npz`` and ``make_predict_fn``, batch 1 and
   batch 32, once through the kernels (the fused decode included) and once with
   ``use_pallas_kernels=False`` (eager encoder, step-by-step decode), same
   generator seed; lengths and flags must be equal on every lane whose stop
   probabilities keep a margin from the threshold, frames and alignments within
   the stated tolerances, and every kernel's launch count exact; then a short
   request on the card against the same request on the CPU; then the same at
   compute_dtype="bfloat16" (the bfloat16 entry points of ``bigru`` and
   ``mha_full``, ``fused_decode``'s bfloat16 branch) against the bfloat16 plain
   path, lengths and flags on the lanes with a margin, launch counts exact, a
   short bfloat16 request on the card against the CPU, and the drift from the
   float32 requests printed; then the baseline
   (``configs/ljspeech_baseline.json``, seeded weights) the same way, and one
   ZoneoutEncoderV1 request, whose encoder is ``bilstm``;
5. training main path: ``Trainer.train_step`` of the flagship from the trained
   weights on a seeded batch of 32 lanes x 800 frames, three steps through the
   kernels and three with ``use_pallas_kernels=False``, same state and generator
   seed: loss parts and ``grad_norm`` must agree, every kernel of the step must
   have been launched once forward and once backward per step, the plain path
   must launch none; an evaluation step on both paths; then the baseline from
   seeded weights: three timed steps through the kernels, one plain, every
   gradient leaf of the first step held, launch counts exact, an evaluation step;
   then the flagship at compute_dtype="bfloat16", the reference's training dtype
   (``phase_training_bf16``): one step from seeded weights through the kernels'
   bfloat16 branches and one on the bfloat16 plain path, every gradient leaf
   printed beside the yardstick (the bfloat16 plain path against the float32 one),
   which the kernel path must not exceed on the median leaf and the loss parts;
   three steps from the trained weights on both paths, launch counts exact, every
   parameter moved, step times; an evaluation step on both;
6. the families served from seeded weights (``FAMILIES``), each through its kernels
   (narrow and off-tile against the plain versions on their first launches, then
   at full width, timed), its main path (``seeded_main_path``: synthesis at batch 1
   and 32 through the kernels and the plain path, launch counts exact) and its
   training (``seeded_training``: three steps of the one-source configuration in
   each io type and one of the two-source one, every gradient leaf of the first
   step against the plain path): the location-sensitive family (``ls``,
   ``flagship-ls``, the latter in both io types) and the WORLD-feature family
   (``mgclf0``, ``flagship-mgclf0``: ``fused_decode``'s lf0 feedback on every pair of
   flags in both io types with early exits, and the teacher kernels in three
   sequential batch blocks against the unsliced run and the per-block plain runs);
7. report: one JSON line ``{"kernels": [...]}`` (every kernel; the bfloat16,
   location-sensitive and lf0 instantiations as entries of their own, the batch
   blocks inside the lf0 family's teacher entries), then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
from self_attention_tacotron_torch.ops.decode_loop import DecodeResult  # noqa: E402
from self_attention_tacotron_torch.synthesis import make_predict_fn  # noqa: E402
from self_attention_tacotron_torch.tools.flagship import (  # noqa: E402
    TRAINED_NPZ as NPZ,
    config_batch,
    config_hparams,
    device_busy,
    flagship_hparams,
    gpu_line,
    load_network,
    ragged_lengths,
    ragged_request,
    training_batch,
)
from self_attention_tacotron_torch.tools.profile_training import timed_step  # noqa: E402
from self_attention_tacotron_torch.training.trainer import (  # noqa: E402
    Trainer,
    targets_from_batch,
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
    ("bilstm", torch.float32): 1e-4, ("bilstm", torch.bfloat16): 3e-2,
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
# The steps of a 500-step request whose stages are stamped (log_stage_times), and
# the design every fused_decode row runs: a persistent grid, one block per SM, each
# block's weight slices resident in shared memory, grid barriers between stages.
STAMP_STEPS = (10, 250, 490)
DECODE_DESIGN = "grid: one block per SM, weights resident in shared memory, grid barriers"
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
# fused_decode in bfloat16 against its bfloat16 plain version on the card: both
# round the same values at the same points, but their float32 sums run in
# another order, and where a sum lands next to a rounding boundary the two round
# one bfloat16 ulp apart, which the loop feeds back. Narrow decoders over 24 steps
# at TOL_FUSED_BF16. The trained flagship amplifies such a flip on the lane where
# it falls (in float32 too its runs leave each other, see FUSED_WINDOWS): over its
# first BF16_EARLY_STEPS steps at B=32 the lane furthest off read 0.03 to 0.14 on
# the draws of masks tried on an H100, the median lane 0.005, and the plain version
# against itself with its memories moved by one bfloat16 ulp 0.50 (median 0.011).
# So those steps are held at TOL_FUSED_BF16_WIDE on the median lane of a batch of
# at least FUSED_MEDIAN_LANES (a fault of the kernel would move every lane) and on
# the largest below that, later windows printed, and that yardstick printed.
# An early exit's threshold needs a gap of BF16_MARGIN_FACTOR times the largest
# difference of the stop logits.
TOL_FUSED_BF16 = 1e-2
TOL_FUSED_BF16_WIDE = 3e-2
BF16_EARLY_STEPS = 50
FUSED_BF16_WINDOWS = ((BF16_EARLY_STEPS, TOL_FUSED_BF16_WIDE, "median"), (256, None, "printed"),
                      (500, None, "printed"))
BF16_MARGIN_FACTOR = 10.0
# A step cap beyond what the kernel took before its self-attention was tiled (1872
# at source length 128): the flagship decodes it in one launch per batch block,
# with the same shared memory as at 500 steps. Seeded weights, which do not spread,
# are held over every step at LONG_CAP_TOL (float32); the trained model's first
# FUSED_STEPS steps at TOL_FUSED and the rest by windows, printed.
LONG_CAP = 2500
LONG_CAP_TOL = 1e-3
# The bfloat16 main path: the kernel path rounds where the Pallas kernel does, the
# plain path (use_pallas_kernels=False) where flax does, so the two differ from the
# first step by bfloat16 roundings, and the trained model's long runs then leave
# each other's trajectory; lengths and flags are held on the lanes that keep
# MAIN_MARGIN and whose two runs stay closer than it (compare_lengths), the floats
# are printed. The card against the CPU (30 steps, the CPU taking the kernel's
# plain version, same injected masks) at TOL_CPU_BF16: the card's encoder kernels
# round like the Pallas kernels, the CPU's eager encoder like flax (6.4e-3 apart
# on an H100).
TOL_CPU_BF16 = 3e-2


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


# The output heads a synthesis gives: the mel frames, or the WORLD heads side by side.
HEADS = ("mel", "mgc", "lf0")


def frames_of(x) -> torch.Tensor:
    """The frame heads side by side in the decoder's order (mel, or mgc then lf0),
    of a ``DecodeResult`` or of a synthesis output dictionary."""
    heads = list(x.frames.values()) if isinstance(x, DecodeResult) else [
        x[h] for h in HEADS if h in x]
    return heads[0] if len(heads) == 1 else torch.cat(heads, dim=-1)


def frame_width(hp: HParams) -> int:
    return hp.num_mgcs + hp.num_lf0s if hp.decoder.startswith("MgcLf0") else hp.num_mels


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


def lstm_params(rng, C, H, dtype):
    s = 1.0 / np.sqrt(C + H)
    return {
        "kernel": torch.tensor(rng.standard_normal((C + H, 4 * H)).astype(np.float32) * s,
                               device=DEV).to(dtype),
        "bias": torch.tensor(rng.standard_normal(4 * H).astype(np.float32) * 0.1,
                             device=DEV).to(dtype),
    }


def check_bilstm(B, S, C, H, lengths, dtype, zoneout: float, timed: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    xs = torch.tensor(rng.standard_normal((B, S, C)).astype(np.float32), device=DEV).to(dtype)
    lens = torch.tensor(np.asarray(lengths, np.int32), device=DEV)
    pf, pb = lstm_params(rng, C, H, dtype), lstm_params(rng, C, H, dtype)
    args = (xs, lens, pf, pb, H, zoneout, zoneout)
    got = fused_rnn.bilstm(*args)
    torch.cuda.synchronize()
    want = fused_rnn.bilstm_reference(*args)
    err = max_abs_err(got, want)
    tol = TOL[("bilstm", dtype)]
    padded_zero = all(
        float(got[b, n:].abs().max()) == 0.0 for b, n in enumerate(lengths) if n < S
    )
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol and padded_zero
    rec = {
        "kernel": "bilstm", "shape": {"B": B, "S": S, "C": C, "H": H}, "zoneout": zoneout,
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol,
        "padded_rows_zero": padded_zero, "ok": ok,
    }
    if timed:
        elem = xs.element_size()
        steps = int(np.minimum(np.asarray(lengths), S).sum())
        flops = 2.0 * steps * 2 * (C + H) * 4 * H
        nbytes = elem * (B * S * C + B * S * 2 * H + 2 * ((C + H) * 4 * H + 4 * H)) + 4 * B
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
        rec.update(
            ms=time_ms(lambda: fused_rnn.bilstm(*args)),
            plain_ms=time_ms(lambda: fused_rnn.bilstm_reference(*args), warmup=1, iters=2),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
        )
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"bilstm disagrees with its plain version: {rec}")
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
        # ZoneoutEncoderV1's LSTM: lanes of length 1 and S, zoneout 0 and 0.1
        check_bilstm(4, 12, 10, 8, [12, 1, 7, 12], dtype, 0.0, timed=False)
        check_bilstm(5, 9, 7, 20, [9, 1, 4, 9, 2], dtype, 0.1, timed=False, seed=1)
        check_bilstm(1, 33, 128, 128, [33], dtype, 0.1, timed=False, seed=2)
        # the flagship shapes, ragged
        lengths = ragged_lengths(np.random.default_rng(3), 32, 128)
        records[("bigru", dtype)] = check_bigru(32, 128, 128, 128, lengths, dtype, timed=True)
        records[("mha_full", dtype)] = check_mha(
            32, 128, 256, 2, lengths.tolist(), dtype, timed=True
        )
        # ZoneoutEncoderV1 at full width: prenet 128 in, 128 units a direction
        records[("bilstm", dtype)] = check_bilstm(
            32, 128, 128, 128, lengths, dtype, 0.1, timed=True, seed=4
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
        memories=memories, keys=keys, masks=tuple(mask for _ in memories), speaker_embed=speaker
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


def exit_threshold(stop_probs: torch.Tensor, steps: int, r: int, required: bool = True):
    """(threshold, gap in logits): the middle of the widest gap between the run's own
    stop logits at which every lane fires before the cap and not all at one step.
    A trained model's early stop probabilities are tiny (1e-10 to 1e-6); float32
    resolves those relatively, so only thresholds near 1 are left out. Where there
    is none: a failure, or (None, 0.0) if not ``required``."""
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
    if best_mid is None and not required:
        return None, 0.0
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
        if name.endswith("_w") and name != "ls_w"
        and (name != "ta_w" or packed.use_transition_agent)
    )
    a_tot, e_tot = z["A1"] + z["A2"], z["E1"] + z["E2"]
    # location-sensitive: K taps times the folded matrix at every valid position; the
    # WORLD heads: the softmax of the fed-back lf0 lanes (max, exp, sum, divide)
    per_step = batch * 2 * products + valid * (4 * a_tot + 2 * e_tot + 2 * z["K"] * z["A1"])
    per_step += batch * 4 * (z["M"] - z["LF0"]) * (z["LF0"] > 0)
    attention = batch * 4 * z["SA"] * steps * (steps + 1) // 2
    flops = steps * per_step + attention
    out_row = z["R"] * z["M"] + z["R"] + (2 if packed.dual else 1) * src_len
    io = packed.flat.element_size()   # weights, keys, memories and cache in the io type
    nbytes = (
        io * packed.flat.numel() + 4 * packed.flat32.numel()
        + batch * src_len * (io * (a_tot + e_tot) + 4)
        + steps * batch * (z["P1"] + z["P2"]) + 4 * batch * steps * out_row + 9 * batch
    )
    cache_bytes = batch * 2 * z["SA"] * io * (steps + steps * (steps + 1) // 2)
    return float(flops), float(nbytes), float(cache_bytes)


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: operations at the peak rate of the
    inputs' type, or bytes at the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def compare_decodes(got, want, r: int):
    """Float differences over the steps both ran; lengths, flags, step count and
    the zero tail are held exactly."""
    steps = int(want.num_steps)
    exact = (
        len(got.alignments) == len(want.alignments)
        and int(got.num_steps) == steps
        and torch.equal(got.lengths, want.lengths)
        and torch.equal(got.finished, want.finished)
        and got.lengths.dtype == torch.int32 and got.finished.dtype == torch.bool
    )
    frames = frames_of(got)
    tail = sum(
        float(x[:, n:].abs().sum())
        for x, n in (
            (frames, steps * r), (got.stop_probs, steps * r),
            *((a, steps) for a in got.alignments),
        )
    )
    finite = all(
        bool(torch.isfinite(x).all())
        for x in (frames, got.stop_probs, *got.alignments)
    )
    errs = {
        "frames": max_abs_err(frames, frames_of(want)),
        "stop_probs": max_abs_err(got.stop_probs, want.stop_probs),
        "alignments": max(max_abs_err(a, b) for a, b in zip(got.alignments, want.alignments)),
        "stop_logits": float(np.abs(
            stop_logits(got.stop_probs[:, : steps * r]) - stop_logits(want.stop_probs[:, : steps * r])
        ).max()),
    }
    return errs, exact, tail == 0.0, finite


def check_fused(name, packed, cond, masks, steps, threshold, early_exit=True, slice_batch=None,
                tol=TOL_FUSED):
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
        and max(errs["frames"], errs["stop_probs"], errs["alignments"]) <= tol
    )
    rec = {
        "kernel": "fused_decode", "case": name,
        "variant": fused_decode.variant_name(packed.dual, packed.use_sa, packed.io_dtype,
                                             packed.ls, packed.lf0),
        "shape": {"B": batch, "S": src_len, "T": steps, **packed.sizes},
        "transition_agent": packed.use_transition_agent, "threshold": threshold,
        "early_exit": early_exit, "launches": launches, "num_steps": int(got.num_steps),
        "lengths": got.lengths.tolist() if batch <= 8 else None,
        "finished": int(got.finished.sum()),
        "max_abs_err": max(errs["frames"], errs["stop_probs"], errs["alignments"]), **errs,
        "tol": tol, "exact_lengths_flags_steps": exact, "zero_tail": zero_tail, "ok": ok,
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
        (frames_of(got)[:, lo * r : hi * r], frames_of(want)[:, lo * r : hi * r]),
        (got.stop_probs[:, lo * r : hi * r], want.stop_probs[:, lo * r : hi * r]),
        *((a[:, lo:hi], b[:, lo:hi]) for a, b in zip(got.alignments, want.alignments)),
    ]
    return torch.stack([(a - b).abs().flatten(1).amax(dim=1) for a, b in pairs]).amax(dim=0)


def window_errors(got, want, r: int, spec=FUSED_WINDOWS):
    windows, lo = [], 0
    for hi, tol, held in spec:
        errs = lane_errors(got, want, r, lo, hi)
        windows.append({
            "steps": [lo, hi], "max": float(errs.max()), "median": float(errs.median()),
            "lanes_above_2e-2": int((errs > 2e-2).sum()), "tol": tol, "held": held,
        })
        lo = hi
    return windows


def check_fused_long(name, got, want, r: int, spec=FUSED_WINDOWS):
    """The trained model's long run to the cap against the plain version's, by
    windows of steps (see FUSED_WINDOWS; FUSED_BF16_WINDOWS in bfloat16)."""
    errs, exact, zero_tail, finite = compare_decodes(got, want, r)
    require(spec[-1][0] == int(want.num_steps), "the windows must cover the run")
    windows = window_errors(got, want, r, spec)
    batch = got.lengths.shape[0]
    ok = finite and exact and zero_tail
    for w in windows:
        if w["held"] == "median" and batch < FUSED_MEDIAN_LANES:
            # a few lanes are held on the largest in bfloat16; float32 holds its
            # earlier windows
            w["held"] = "max" if spec is FUSED_BF16_WINDOWS else (
                "not held: too few lanes for a median")
        if w["held"] in ("max", "median"):
            ok = ok and w[w["held"]] <= w["tol"]
    rec = {
        "kernel": "fused_decode", "case": name, "num_steps": int(got.num_steps), **errs,
        "windows": windows, "exact_lengths_flags_steps": exact, "zero_tail": zero_tail, "ok": ok,
    }
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"fused_decode disagrees with its plain version: {rec}")
    return rec


def check_long_cap(flagship, rng) -> dict:
    """The flagship at LONG_CAP steps, beyond the 1872 that one block's shared memory
    held before the decoder self-attention was tiled: one launch per request
    (B=32 and B=1, under the launch limit of MAX_LANES lanes), one block's shared memory the same
    as at the main path's step cap, every launch held against the plain version by
    windows of steps: seeded weights at the flagship's widths on every step, the
    trained weights on the first FUSED_STEPS (see LONG_CAP)."""
    hp = flagship.hparams
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    trained = fused_decode.pack_decoder(flagship.decoder)
    need, have = fused_decode.block_shared_memory(trained.sizes, 128, hp.max_iters, DEV)
    need_long, _ = fused_decode.block_shared_memory(trained.sizes, 128, LONG_CAP, DEV)
    limit = fused_decode.fused_decode_max_batch(hp, LONG_CAP, 128)
    rec = {
        "kernel": "fused_decode", "case": f"step cap {LONG_CAP}: launch limit",
        "lanes_per_launch": limit, "sms": sms, "block_needs_at_cap": need_long,
        f"block_needs_at_{hp.max_iters}": need, "sm_offers": have,
    }
    log("check " + json.dumps(rec))
    plan = fused_decode.grid_plan(trained.sizes, sms, trained.io_dtype, 128)
    rec_plan = {"kernel": "fused_decode", "case": "grid plan against the built kernel",
                "sms": sms, "plan_smem_bytes": plan.smem_bytes, "kernel_smem_bytes": need,
                "largest_weight_slice_bytes": max(plan.weight_bytes),
                "smallest_weight_slice_bytes": min(plan.weight_bytes)}
    log("check " + json.dumps(rec_plan))
    require(plan.smem_bytes == need, "the grid plan's shared memory is not the kernel's")
    require(limit == fused_decode.MAX_LANES, "the launch limit is not MAX_LANES lanes")
    require(need_long == need <= have, "one block's shared memory must not grow with the cap")
    r = trained.sizes["R"]
    wide = seeded_decoder(flagship_hparams(), seed=3)
    seeded = fused_decode.pack_decoder(wide)
    held = ((FUSED_STEPS, TOL_FUSED, "max"), (512, LONG_CAP_TOL, "max"),
            (LONG_CAP, LONG_CAP_TOL, "max"))
    printed = ((FUSED_STEPS, TOL_FUSED, "max"), (512, None, "printed"),
               (LONG_CAP, None, "printed"))
    records = {}
    for label, packed, windows in (("seeded weights", seeded, held),
                                   ("trained weights", trained, printed)):
        for batch, longest in ((32, 128), (1, 97)):
            req = ragged_request(rng, batch, longest)
            if packed is trained:
                cond = flagship_conditioning(flagship, req, seed=batch)
            else:
                cond = seeded_conditioning(wide, rng, req["source_lengths"].tolist(), longest)
            masks = seeded_masks(packed, rng, LONG_CAP, batch)
            before = fused_decode.launch_count
            got, ms = timed_once(lambda: fused_decode.fused_decode(
                packed, cond, masks, LONG_CAP, 2.0, early_exit=False))
            launched = fused_decode.launch_count - before
            want = fused_decode.fused_decode_reference(packed, cond, masks, LONG_CAP, 2.0, False)
            errs, exact, zero_tail, finite = compare_decodes(got, want, r)
            wins = window_errors(got, want, r, windows)
            ok = finite and exact and zero_tail and launched == 1 and all(
                w["max"] <= w["tol"] for w in wins if w["held"] == "max")
            rec = {
                "kernel": "fused_decode", "case": f"flagship {label}, B={batch}, {LONG_CAP} steps",
                "launches": launched, "num_steps": int(got.num_steps), "ms": ms,
                "ms_per_step": ms / LONG_CAP, **errs, "windows": wins,
                "exact_lengths_flags_steps": exact, "zero_tail": zero_tail, "ok": ok,
            }
            log("check " + json.dumps(rec))
            if not ok:
                raise SystemExit(f"fused_decode at step cap {LONG_CAP} disagrees: {rec}")
            records[(label, batch)] = rec
    return records


def check_fused_with_exit(name, packed, cond, rng, steps, slice_batch=None, tol=TOL_FUSED,
                          margin_factor=FUSED_MARGIN_FACTOR, masks=None, gap_required=True):
    """To the cap first; then at a threshold from that run's own stop probabilities,
    with the early exit and without it, where every integer and flag must be equal.
    The prenet masks are drawn from ``rng`` unless given. Where the widest gap
    between the stop logits is under the margin, a failure, or with
    ``gap_required=False`` None (the run to the cap has been held)."""
    batch = cond.memories[0].shape[0]
    if masks is None:
        masks = seeded_masks(packed, rng, steps, batch)
    rec, want = check_fused(name + ", to the cap", packed, cond, masks, steps, 2.0,
                            slice_batch=slice_batch, tol=tol)
    threshold, gap = exit_threshold(want.stop_probs, steps, packed.sizes["R"])
    need = margin_factor * rec["stop_logits"]
    log("check " + json.dumps({
        "kernel": "fused_decode", "case": name + ", threshold", "threshold": threshold,
        "gap_in_logits": gap, "needed": need,
    }))
    if gap < need and not gap_required:
        return None
    require(gap >= need, f"{name}: the widest gap between stop logits ({gap}) is under {need}")
    rec_exit, _ = check_fused(name + ", early exit", packed, cond, masks, steps, threshold,
                              tol=tol)
    require(rec_exit["num_steps"] < steps and rec_exit["finished"] == batch,
            f"{name}: the threshold did not end the run early")
    rec_late, _ = check_fused(name + ", exit off", packed, cond, masks, steps, threshold,
                              early_exit=False, tol=tol)
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
    long_cap = check_long_cap(flagship, np.random.default_rng(14))

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
        records[batch].update(
            ms=ms, ms_per_step=ms / steps, steps_timed=steps, plain_ms=plain_ms,
            **bound(flops, nbytes, torch.float32),
            flops=flops, bytes=nbytes, cache_prefix_bytes=cache_bytes,
            stage_us=log_stage_times(f"flagship float32 B={batch}", packed, cond, masks, steps),
        )
        log("check " + json.dumps({
            "kernel": "fused_decode", "case": f"flagship B={batch}, time",
            **{k: v for k, v in records[batch].items()
               if k in ("ms", "ms_per_step", "steps_timed", "plain_ms", "bound_ms", "bound_by",
                        "flops", "bytes", "cache_prefix_bytes")},
        }))
    records["long_cap"] = long_cap
    return records


def log_stage_times(name, packed, cond, masks, steps: int) -> dict:
    """Where a step's time goes: microseconds of each stage of the steps STAMP_STEPS
    of one launch to the cap (block 0's %globaltimer at the grid barriers; a stage's
    ``_wait`` is block 0's wait at its barrier), one launch per stamped step."""
    times = {str(step): fused_decode.stage_times(packed, cond, masks, steps, step)
             for step in STAMP_STEPS}
    log("stages " + json.dumps({"kernel": "fused_decode", "case": name, "design": DECODE_DESIGN,
                                "us": times}))
    return times


def time_fused(name, packed, cond, masks, lengths, steps: int):
    """Time of one launch to the cap (no exit) by CUDA events, that launch against
    the plain version's run over all the steps (seeded weights: TOL_FUSED in float32;
    bfloat16 by FUSED_BF16_WINDOWS), and the bound of the work these inputs need."""
    def run():
        return fused_decode.fused_decode(packed, cond, masks, steps, 2.0, early_exit=False)

    ms = time_ms(run, warmup=1, iters=3)
    want, plain_ms = timed_once(
        lambda: fused_decode.fused_decode_reference(packed, cond, masks, steps, 2.0, False)
    )
    got = run()
    errs, exact, zero_tail, finite = compare_decodes(got, want, packed.sizes["R"])
    err = max(errs["frames"], errs["stop_probs"], errs["alignments"])
    flops, nbytes, _ = fused_flops_and_bytes(packed, lengths, steps)
    rec = {
        "kernel": "fused_decode", "case": name,
        "variant": fused_decode.variant_name(packed.dual, packed.use_sa, packed.io_dtype,
                                             packed.ls, packed.lf0),
        "shape": {"B": len(lengths), "S": int(max(lengths)), "T": steps, **packed.sizes},
        "ms": ms, "ms_per_step": ms / steps, "steps_timed": steps, "plain_ms": plain_ms,
        **bound(flops, nbytes, packed.io_dtype), "flops": flops,
        "bytes": nbytes, "max_abs_err": err, **errs,
        "exact_lengths_flags_steps": exact, "zero_tail": zero_tail,
    }
    if packed.io_dtype == torch.float32:
        rec.update(tol=TOL_FUSED, ok=finite and exact and zero_tail and err <= TOL_FUSED)
    else:
        spec = tuple((hi, tol, held) for hi, tol, held in FUSED_BF16_WINDOWS if hi < steps)
        spec += ((steps, TOL_FUSED_BF16_WIDE, "max") if not spec else (steps, None, "printed"),)
        rec["windows"] = window_errors(got, want, packed.sizes["R"], spec)
        early = rec["windows"][0]
        rec["ok"] = finite and exact and zero_tail and early["max"] <= early["tol"]
    log("check " + json.dumps(rec))
    if not rec["ok"]:
        raise SystemExit(f"fused_decode disagrees with its plain version: {rec}")
    return rec


def check_baseline_long_cap(packed, hp, cond, rng, cap: int):
    """The baseline (no self-attention) at a long step cap, one launch: its first
    FUSED_STEPS steps are held against the plain version's run of that length."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    limit = fused_decode.fused_decode_max_batch(hp, cap, 128)
    need, have = fused_decode.block_shared_memory(packed.sizes, 128, cap, DEV)
    masks = seeded_masks(packed, rng, cap, 1)
    before = fused_decode.launch_count
    got, ms = timed_once(
        lambda: fused_decode.fused_decode(packed, cond, masks, cap, 2.0, early_exit=False)
    )
    launched = fused_decode.launch_count - before
    want = fused_decode.fused_decode_reference(
        packed, cond, tuple(m[:FUSED_STEPS] for m in masks), FUSED_STEPS, 2.0, False
    )
    r = packed.sizes["R"]
    err = max(
        max_abs_err(frames_of(got)[:, : FUSED_STEPS * r], frames_of(want)),
        max_abs_err(got.stop_probs[:, : FUSED_STEPS * r], want.stop_probs),
        max_abs_err(got.alignments[0][:, :FUSED_STEPS], want.alignments[0]),
    )
    finite = all(bool(torch.isfinite(x).all()) for x in (frames_of(got), got.stop_probs))
    rec = {
        "kernel": "fused_decode", "case": f"baseline at step cap {cap}",
        "variant": fused_decode.variant_name(packed.dual, packed.use_sa),
        "max_iters": cap, "lanes_per_launch": limit, "block_needs": need, "sm_offers": have,
        "launches": launched, "num_steps": int(got.num_steps), "ms": ms,
        "first_steps_max_abs_err": err, "first_steps": FUSED_STEPS, "tol": TOL_FUSED,
    }
    rec["ok"] = (limit == fused_decode.MAX_LANES and need <= have and launched == 1
                 and int(got.num_steps) == cap and finite and err <= TOL_FUSED)
    log("check " + json.dumps(rec))
    if not rec["ok"]:
        raise SystemExit(f"the baseline must decode at step cap {cap}: {rec}")


# Seeded decoders without self-attention keep their stop logits within a few tenths
# of 0, where no threshold lets every lane fire at a step of its own with a margin;
# for the checks of the early exit the stop rows of their output projection are
# scaled by this much, which spreads the logits as a trained model's are spread and
# leaves the frames as they are.
STOP_SPREAD = 8.0


def spread_stop_logits(decoder, factor: float = STOP_SPREAD) -> None:
    r = decoder.outputs_per_step
    with torch.no_grad():
        decoder.output_projection.weight[-r:].mul_(factor)
        decoder.output_projection.bias[-r:].mul_(factor)


def shape_stop_rows(decoder, factor: float, shift: float) -> None:
    """The stop logits mapped to ``factor * logit - shift`` (rows scaled, bias shifted)."""
    spread_stop_logits(decoder, factor)
    with torch.no_grad():
        decoder.output_projection.bias[-decoder.outputs_per_step:] -= shift


def spread_for_exit(decoder, cond, masks, steps: int) -> float:
    """Spread the stop rows of a decoder with seeded weights (which never stops on
    its own) so that its plain run to the cap on these masks has a threshold at
    which every lane fires at a step of its own: not at all, by STOP_SPREAD, or by
    -STOP_SPREAD (which of them rises over the steps depends on the weights), the
    first that has one. Returns the factor applied; fails where none has."""
    for factor in (1.0, STOP_SPREAD, -STOP_SPREAD):
        spread_stop_logits(decoder, factor)
        run = fused_decode.fused_decode_reference(
            fused_decode.pack_decoder(decoder), cond, masks, steps, 2.0, early_exit=False)
        if exit_threshold(run.stop_probs, steps, decoder.outputs_per_step, required=False)[0]:
            return factor
        spread_stop_logits(decoder, 1.0 / factor)
    raise SystemExit("no spread of the stop rows lets every lane fire at a step of its own")


def phase_baseline_decode():
    """The three specialisations of ``fused_decode`` that the flagship does not
    launch, at narrow sizes with injected masks; the baseline (one source, no
    self-attention) at full width with seeded weights, conditioning from its real
    encoder; and the baseline at LONG_CAP steps."""
    steps = 24
    single = {"encoder": "EncoderV1"}
    for case, (name, overrides, lengths, src_len, spk) in enumerate((
        ("narrow DualSourceDecoder B=3 S=11", {"decoder": "DualSourceDecoder"}, [11, 7, 4], 11, 0),
        ("narrow ExtendedDecoder B=5 S=13, transition agent",
         {**single, "decoder": "ExtendedDecoder", "attention": "forward_transition_agent"},
         [13, 5, 9, 1, 12], 13, 0),
        ("narrow SelfAttentionDecoder B=5 S=9, speaker embedding",
         {**single, "decoder": "SelfAttentionDecoder", "use_speaker_embedding": True,
          "num_speakers": 4, "speaker_embedding_dim": 6}, [9, 9, 3, 6, 2], 9, 6),
        ("narrow ExtendedDecoder B=6 S=7 r=3, odd widths, prenet dropout 0",
         {**single, "decoder": "ExtendedDecoder", "decoder_prenet_drop_rate": 0.0,
          "decoder_prenet_out_units": (20, 12), "attention_out_units": 28,
          "attention1_out_units": 10, "decoder_out_units": 36, "num_mels": 7,
          "outputs_per_step": 3, "cbhg_out_units": 20}, [7, 2, 5, 7, 7, 3], 7, 0),
    )):
        rng = np.random.default_rng(31 + case)
        decoder = seeded_decoder(narrow_hparams(**overrides), seed=len(lengths) + src_len)
        if decoder.self_attention is None:
            spread_stop_logits(decoder)
        cond = seeded_conditioning(decoder, rng, lengths, src_len, spk)
        check_fused_with_exit(name, fused_decode.pack_decoder(decoder), cond, rng, steps)

    # the baseline at full width: seeded weights, conditioning from its encoder
    net = load_network("baseline", seed=3)
    hp = net.hparams
    packed = fused_decode.pack_decoder(net.decoder)
    spread_stop_logits(net.decoder)
    packed_exit = fused_decode.pack_decoder(net.decoder)
    spread_stop_logits(net.decoder, 1.0 / STOP_SPREAD)
    rng = np.random.default_rng(32)
    records = {}
    for batch, longest in ((32, 128), (1, 97)):
        req = ragged_request(rng, batch, longest)
        cond = flagship_conditioning(net, req, seed=batch)
        exit_rec = check_fused_with_exit(
            f"baseline B={batch} S={longest}", packed_exit, cond, rng, FUSED_STEPS
        )
        masks = seeded_masks(packed, rng, hp.max_iters, batch)
        records[batch] = time_fused(
            f"baseline B={batch} S={longest}, {hp.max_iters} steps, time", packed, cond, masks,
            req["source_lengths"], hp.max_iters,
        )
        records[batch]["exit_max_abs_err"] = exit_rec["max_abs_err"]
        if batch == 1:
            check_baseline_long_cap(packed, hp, cond, rng, LONG_CAP)
    return records


def check_model_threshold(name, packed, cond, masks, steps: int, threshold: float):
    """The trained model at its own stop threshold with the early exit, against the
    plain version's run: lengths and flags exact on the lanes whose plain stop
    probabilities keep MAIN_MARGIN from the threshold and the two runs' stay closer
    than that (see ``compare_lengths``), the first BF16_EARLY_STEPS steps as
    FUSED_BF16_WINDOWS holds them; the number of lanes held is printed."""
    r = packed.sizes["R"]
    got = fused_decode.fused_decode(packed, cond, masks, steps, threshold)
    want = fused_decode.fused_decode_reference(packed, cond, masks, steps, threshold)

    def fields(res):
        return {"stop_probs": res.stop_probs, "lengths": res.lengths,
                "finished": res.finished, "num_steps": res.num_steps}

    left_out = compare_lengths(fields(got), fields(want), threshold, r, apart_below_margin=True)
    early = min(BF16_EARLY_STEPS, int(got.num_steps), int(want.num_steps))
    errs = lane_errors(got, want, r, 0, early)
    held = "median" if len(errs) >= FUSED_MEDIAN_LANES else "max"
    err = float(errs.median() if held == "median" else errs.max())
    finite = all(bool(torch.isfinite(x).all()) for x in (frames_of(got), got.stop_probs))
    rec = {
        "kernel": "fused_decode", "case": name, "threshold": threshold,
        "num_steps": [int(got.num_steps), int(want.num_steps)],
        "finished": [int(got.finished.sum()), int(want.finished.sum())],
        "lanes_held": int(got.lengths.shape[0]) - len(left_out),
        "lanes_left_out_of_the_exact_comparison": left_out, "margin": MAIN_MARGIN,
        "early_steps": early, "early_max": float(errs.max()), "early_median": float(errs.median()),
        "held": held, "tol": TOL_FUSED_BF16_WIDE, "ok": finite and err <= TOL_FUSED_BF16_WIDE,
    }
    log("check " + json.dumps(rec))
    if not rec["ok"]:
        raise SystemExit(f"fused_decode disagrees with its plain version: {rec}")


def phase_fused_decode_bf16():
    """The bfloat16 branch of ``fused_decode`` against its bfloat16 plain version:
    each pair of flags at narrow and off-tile sizes with injected masks and an early
    exit (TOL_FUSED_BF16 over 24 steps), and two batch blocks; the flagship at full
    width from the trained weights, B=32 and B=1: over BF16_EARLY_STEPS steps (B=1
    with an early exit at a threshold from the plain run), at the model's own
    threshold over 500 steps with the early exit, and timed over 500 steps, held by
    FUSED_BF16_WINDOWS; then the
    two specialisations that no configuration runs (``dual=1,use_sa=0``,
    ``dual=0,use_sa=1``) at the flagship's widths from seeded weights, B=32, 500
    steps, timed in both io types."""
    steps = 24
    single = {"encoder": "EncoderV1"}
    odd = {"decoder_prenet_drop_rate": 0.0, "decoder_prenet_out_units": (20, 12),
           "attention_out_units": 28, "attention1_out_units": 10, "decoder_out_units": 36,
           "decoder_self_attention_out_units": 24, "num_mels": 7, "outputs_per_step": 3,
           "cbhg_out_units": 20}
    for case, (name, overrides, lengths, src_len, spk) in enumerate((
        ("narrow B=3 S=11", {}, [11, 7, 4], 11, 0),
        ("narrow B=5 S=13, transition agent",
         {"attention": "forward_transition_agent"}, [13, 5, 9, 1, 12], 13, 0),
        ("narrow DualSourceDecoder B=5 S=9, speaker embedding",
         {"decoder": "DualSourceDecoder", "use_speaker_embedding": True, "num_speakers": 4,
          "speaker_embedding_dim": 6}, [9, 9, 3, 6, 2], 9, 6),
        ("narrow ExtendedDecoder B=3 S=11", {**single, "decoder": "ExtendedDecoder"},
         [11, 7, 4], 11, 0),
        ("narrow SelfAttentionDecoder B=6 S=7 r=3, odd widths, prenet dropout 0",
         {**single, **odd, "decoder": "SelfAttentionDecoder"}, [7, 2, 5, 7, 7, 3], 7, 0),
    )):
        rng = np.random.default_rng(41 + case)
        decoder = seeded_decoder(narrow_hparams(compute_dtype="bfloat16", **overrides),
                                 seed=len(lengths) + src_len)
        if decoder.self_attention is None:
            spread_stop_logits(decoder)
        cond = seeded_conditioning(decoder, rng, lengths, src_len, spk)
        packed = fused_decode.pack_decoder(decoder)
        check_fused_with_exit(f"bf16 {name}", packed, cond, rng, steps, tol=TOL_FUSED_BF16,
                              margin_factor=BF16_MARGIN_FACTOR)
    check_fused("bf16 narrow SelfAttentionDecoder B=6, two batch blocks", packed, cond,
                seeded_masks(packed, rng, steps, 6), steps, 2.0, slice_batch=4,
                tol=TOL_FUSED_BF16)

    # the flagship from its trained weights, conditioning from its real encoder
    flagship = convert.load_npz(NPZ, flagship_hparams(compute_dtype="bfloat16"))
    packed = fused_decode.pack_decoder(flagship.decoder)
    r, steps = packed.sizes["R"], flagship.hparams.max_iters
    rng = np.random.default_rng(42)
    records = {}
    for batch, longest in ((32, 128), (1, 97)):
        req = ragged_request(rng, batch, longest)
        cond = flagship_conditioning(flagship, req, seed=batch)
        name = f"bf16 flagship B={batch} S={longest}"
        if batch == 1:
            # 32 trained lanes crowd their early stop logits: no threshold that fires
            # every lane within a short run keeps a gap; one lane does
            check_fused_with_exit(name, packed, cond, rng, BF16_EARLY_STEPS,
                                  tol=TOL_FUSED_BF16_WIDE, margin_factor=BF16_MARGIN_FACTOR)
        masks = seeded_masks(packed, rng, steps, batch)
        check_model_threshold(name + f", its own threshold, {steps} steps", packed, cond, masks,
                              steps, flagship.hparams.stop_token_threshold)
        run = lambda: fused_decode.fused_decode(  # noqa: E731
            packed, cond, masks, steps, 2.0, early_exit=False
        )
        ms = time_ms(run, warmup=1, iters=3)
        want, plain_ms = timed_once(
            lambda: fused_decode.fused_decode_reference(packed, cond, masks, steps, 2.0, False)
        )
        long_rec = check_fused_long(f"bf16 flagship B={batch}, {steps} steps", run(), want, r,
                                    FUSED_BF16_WINDOWS)
        if batch == 32:
            # the yardstick: how far the plain version itself moves in bfloat16
            moved = dataclasses.replace(
                cond, memories=tuple(m * (1.0 + 2.0 ** -8) for m in cond.memories))
            log("check " + json.dumps({
                "kernel": "fused_decode",
                "case": f"bf16 flagship B={batch}, {steps} steps, plain version against itself "
                        "with the memories moved by one bfloat16 ulp",
                "windows": window_errors(
                    fused_decode.fused_decode_reference(packed, moved, masks, steps, 2.0, False),
                    want, r, FUSED_BF16_WINDOWS),
            }))
        flops, nbytes, cache_bytes = fused_flops_and_bytes(packed, req["source_lengths"], steps)
        records[batch] = {
            "shape": {"B": batch, "S": longest, **packed.sizes},
            "max_abs_err": long_rec["windows"][0]["max"],
            "median_lane_err": long_rec["windows"][0]["median"],
            "ms": ms, "ms_per_step": ms / steps, "steps_timed": steps, "plain_ms": plain_ms,
            **bound(flops, nbytes, torch.bfloat16), "flops": flops, "bytes": nbytes,
            "cache_prefix_bytes": cache_bytes,
            "stage_us": log_stage_times(f"flagship bfloat16 B={batch}", packed, cond, masks,
                                        steps),
        }
        log("check " + json.dumps({
            "kernel": "fused_decode", "case": f"bf16 flagship B={batch}, time",
            **{k: v for k, v in records[batch].items()
               if k in ("ms", "ms_per_step", "steps_timed", "plain_ms", "bound_ms", "bound_by",
                        "flops", "bytes", "cache_prefix_bytes")},
        }))
    del flagship, packed

    # the specialisations that no configuration of configs/ runs, at flagship widths
    rng = np.random.default_rng(43)
    lengths = ragged_lengths(rng, 32, 128).tolist()
    for name, overrides in (("DualSourceDecoder", {"decoder": "DualSourceDecoder"}),
                            ("SelfAttentionDecoder", {**single,
                                                      "decoder": "SelfAttentionDecoder"})):
        for dtype in ("float32", "bfloat16"):
            decoder = seeded_decoder(flagship_hparams(compute_dtype=dtype, **overrides), seed=9)
            packed = fused_decode.pack_decoder(decoder)
            cond = seeded_conditioning(decoder, rng, lengths, 128)
            masks = seeded_masks(packed, rng, steps, len(lengths))
            rec = time_fused(f"{name} at the flagship's widths, seeded, {dtype}, B=32 S=128, "
                             f"{steps} steps, time", packed, cond, masks, lengths, steps)
            records[(name, dtype)] = rec
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
        name: float((got[name].float() - w.float()).abs().max()) / max(float(w.abs().max()), 1e-6)
        for name, w in want.items() if w is not None
    }


@contextlib.contextmanager
def plain_bigru_train():
    """``bigru_train`` with its two kernels' plain versions in their place, on CUDA
    tensors: the plain version of the autograd function, whose bfloat16 backward
    rounds at the kernels' points (autograd through ``bigru_reference`` rounds
    elsewhere). Launches nothing."""
    saved = fused_rnn.bigru, fused_rnn.bigru_bwd_carry
    fused_rnn.bigru = fused_rnn.bigru_reference
    fused_rnn.bigru_bwd_carry = fused_rnn.bigru_bwd_carry_reference
    try:
        yield
    finally:
        fused_rnn.bigru, fused_rnn.bigru_bwd_carry = saved


# bfloat16 kernels against their bfloat16 plain versions, each output and gradient
# leaf in ||delta|| / ||ref||, against the plain version's own bfloat16-against-
# float32 difference on the same inputs (its gap, measured the same way): every
# leaf within BF16_LEAF_SHARE of its gap (or BF16_FLOOR where the gap is smaller)
# and the median leaf within BF16_MEDIAN_SHARE. Both round at the same points, and
# narrow cases agree to 1e-7; float32 sums in another order flip a rounding now and
# then by one bfloat16 ulp, and the recurrences carry the flips through their steps.
# A leaf stored in bfloat16 (keys', memories' and feeds' gradients, bigru_train's
# output and d_xs) has a gap made mostly of its own final rounding, so flips alone
# read up to half of it there (the baseline's mem1 at 0.50, bigru_train's d_xs at
# 0.28, at full width; the other leaves 0.08 to 0.23). A rounding point that
# differs reads about the gap on every leaf after it (0.65 to 0.83 for the points
# where XLA rounds otherwise, tests/test_torch_training_bf16.py). The largest
# entries are printed too.
BF16_LEAF_SHARE = 0.75
BF16_MEDIAN_SHARE = 0.25
BF16_FLOOR = 1e-6


def bf16_shares(errs, gaps):
    """(each leaf's error over its gap, the check passes) for the rule above."""
    shares = {k: v / max(gaps[k], BF16_FLOOR) for k, v in errs.items()}
    ok = (max(shares.values()) <= BF16_LEAF_SHARE
          and float(np.median(list(shares.values()))) <= BF16_MEDIAN_SHARE)
    return shares, ok


def norm_relative(got, want):
    """Per name, ||got - want|| / ||want||."""
    return {
        name: float((got[name].double() - w.double()).norm() / w.double().norm().clamp_min(1e-30))
        for name, w in want.items() if w is not None
    }


def check_bigru_train(B, S, C, H, lengths, timed: bool, seed: int = 0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arr = lambda *shape: torch.tensor(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32), device=DEV)
    xs0, cot = arr(B, S, C).to(dtype), arr(B, S, 2 * H)
    lens = torch.tensor(np.asarray(lengths, np.int32), device=DEV)
    params = [gru_params(rng, C, H, torch.float32) for _ in range(2)]
    bf16 = dtype == torch.bfloat16

    def run(fn, xs_in=None):
        xs = (xs0 if xs_in is None else xs_in).clone().requires_grad_(True)
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
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    rec = {"kernel": "bigru_bwd", "shape": {"B": B, "S": S, "C": C, "H": H},
           "dtype": "bfloat16" if bf16 else "float32", "launches_fwd_bwd": list(launches)}
    if not bf16:
        want = run(fused_rnn.bigru_reference)
        errs = relative_errors(got, want)
        y_err = max_abs_err(got["y"], want["y"])
        grad_err = max(v for k, v in errs.items() if k != "y")
        ok = (finite and launches == (1, 1) and y_err <= TOL[("bigru", torch.float32)]
              and grad_err <= TOL_BIGRU_GRAD)
        rec.update({"y_max_abs_err": y_err, "grad_max_rel_err": grad_err, "grad_rel_errs": errs,
                    "tol_y": TOL[("bigru", torch.float32)], "tol_grad_rel": TOL_BIGRU_GRAD})
    else:
        with plain_bigru_train():
            want = run(fused_rnn.bigru_train)
            wide = run(fused_rnn.bigru_train, xs0.float())    # the yardstick, float32
        require(launches == (1, 1) and (fused_rnn.launch_count, fused_rnn.bwd_launch_count)
                == (before[0] + 1, before[1] + 1), "the plain versions launched a kernel")
        errs, gaps = norm_relative(got, want), norm_relative(want, wide)
        shares, within = bf16_shares(errs, gaps)
        largest = relative_errors(got, want)
        ok = finite and launches == (1, 1) and within
        rec.update({"y_max_abs_err": max_abs_err(got["y"], want["y"]),
                    "grad_max_rel_err": max(v for k, v in largest.items() if k != "y"),
                    "norm_rel_errs": errs, "bf16_against_f32_norm_rel": gaps,
                    "largest_share_of_gap": max(shares.values()),
                    "median_share_of_gap": float(np.median(list(shares.values())))})
    rec["ok"] = ok
    if timed:
        # the carry kernel alone, on the operands the backward hands it
        weights = [p[k] for p in params for k in fused_rnn._PARAM_KEYS]
        rz, n, hp, _, _, wgh_t, wch_t = fused_rnn.bwd_operands(xs0, got["y"], weights, H)
        args = (cot, rz, n, hp, lens, wgh_t, wch_t)
        g_kernel = fused_rnn.bigru_bwd_carry(*args)
        g_plain = fused_rnn.bigru_bwd_carry_reference(*args)
        steps = int(np.minimum(np.asarray(lengths), S).sum())
        flops = 2.0 * steps * 2 * 3 * H * H
        io_bytes = 2.0 if bf16 else 4.0
        nbytes = (4.0 * (B * S * 2 * H * (1 + 2 + 2) + B * S * H * 2 * 3 + B)
                  + io_bytes * 2 * 3 * H * H)
        rec.update(
            max_abs_err=max(max_abs_err(a, b) for a, b in zip(g_kernel, g_plain)),
            ms=time_ms(lambda: fused_rnn.bigru_bwd_carry(*args)),
            plain_ms=time_ms(
                lambda: fused_rnn.bigru_bwd_carry_reference(*args), warmup=1, iters=2),
            train_fwd_bwd_ms=time_ms(lambda: run(fused_rnn.bigru_train), warmup=1, iters=5),
            **bound(flops, nbytes, dtype), flops=flops, bytes=nbytes,
        )
        if bf16:
            with plain_bigru_train():
                rec["plain_fwd_bwd_ms"] = time_ms(lambda: run(fused_rnn.bigru_train),
                                                  warmup=0, iters=2)
        else:
            rec["plain_fwd_bwd_ms"] = time_ms(lambda: run(fused_rnn.bigru_reference),
                                              warmup=0, iters=2)
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"bigru_train disagrees with autograd through its plain version: {rec}")
    return rec


def phase_bigru_bwd():
    """``bigru_train`` in float32 against autograd through ``bigru_reference``, and in
    bfloat16 against the same function with its kernels' plain versions; timed at
    full width in both io types. Returns ``{dtype name: the full-width record}``."""
    lengths = ragged_lengths(np.random.default_rng(3), 32, 128)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        check_bigru_train(4, 12, 10, 8, [12, 7, 1, 12], timed=False, dtype=dtype)
        check_bigru_train(5, 9, 7, 20, [9, 1, 4, 9, 2], timed=False, seed=1, dtype=dtype)
        check_bigru_train(1, 33, 128, 128, [33], timed=False, seed=2, dtype=dtype)
        records[str(dtype).removeprefix("torch.")] = check_bigru_train(
            32, 128, 128, 128, lengths, timed=True, seed=3, dtype=dtype)
    return records


def seeded_teacher_operands(rng, z, B, S, lengths, use_ta, spk, zc, zo, eval_zoneout,
                            dual=True, ls=None, taps=31):
    """Operands of ``teacher_decode`` at the sizes ``z`` with weights from ``rng``;
    ``dual=False``: one source, and ``z``'s A2 and E2 are not used; ``ls``
    ("cum" or "prev"): location-sensitive attention of ``taps`` taps over the
    cumulative or the previous alignments."""
    def arr(*shape, scale=0.3):
        return torch.tensor(
            rng.standard_normal(shape).astype(np.float32) * np.float32(scale), device=DEV)

    fan = lambda k: 1.0 / np.sqrt(k)  # noqa: E731
    if not dual:
        z = dict(z, A2=0, E2=0)
    A = z["A1"] + z["A2"]
    in_att = z["P2"] + spk + z["E1"] + z["E2"] + z["AU"]
    in1 = z["AU"] + z["E1"] + z["E2"] + z["DU"]
    vblk = torch.zeros(A, 2 if dual else 1, device=DEV)
    vblk[: z["A1"], 0] = arr(z["A1"])
    if dual:
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
    if ls:
        weights.update(w_lsW=arr(taps, z["A1"]), ls_bias=arr(z["A1"]))
    lens = torch.tensor(lengths, device=DEV)
    return dict(
        weights=weights, keys=arr(B, S, A), mem1=arr(B, S, z["E1"]),
        mem2=arr(B, S, z["E2"]) if dual else None,
        spk=arr(B, spk) if spk else None,
        score_bias=torch.where(torch.arange(S, device=DEV)[None] < lens[:, None], 0.0, -1e9).float(),
        hp_like=dict(
            dual=dual, use_ta=use_ta, att_units=z["AU"], att1_units=z["A1"],
            att2_units=z["A2"], dec_units=z["DU"], zoneout_cell=zc, zoneout_output=zo,
            prenet_drop_rate=0.0 if z.get("no_dropout") else 0.5, io_dtype="float32",
            src1_kind="location_sensitive" if ls else "forward", ls_cumulative=ls != "prev",
            ls_kernel=taps if ls else 0, eval_zoneout=eval_zoneout,
        ),
    )


def teacher_flops_and_bytes(ops, feeds, lengths, backward: bool):
    """What one launch needs on these inputs. Operations: every product of the
    step once (the backward's are against the transposed weights; the weight
    gradients are batched products outside the kernel), the score pass over the
    valid positions (the backward recomputes it and adds its adjoint) and the
    contexts. Bytes: weights, conditioning and per-step rows read once, outputs
    written once; the weights, feeds, keys, memories, speaker embedding and
    gradient rows in the io type, the rest float32."""
    hp_like, w = ops["hp_like"], ops["weights"]
    B, N = feeds.shape[:2]
    S = ops["keys"].shape[1]
    n_src = 1 if ops["mem2"] is None else 2
    z = dict(P2=w["w_p2"].shape[1], SPK=0 if ops["spk"] is None else ops["spk"].shape[1],
             AU=hp_like["att_units"], A1=hp_like["att1_units"],
             A2=hp_like["att2_units"] if n_src == 2 else 0, DU=hp_like["dec_units"],
             E1=ops["mem1"].shape[-1], E2=0 if n_src == 1 else ops["mem2"].shape[-1])
    A, E = z["A1"] + z["A2"], z["E1"] + z["E2"]
    core = [n for n in fused_teacher.core_weights(hp_like)
            if hp_like["use_ta"] or n not in ("w_ta", "b_ta")]
    # the folded location taps are no product of a lane's row: counted per position
    products = sum(w[n].numel() for n in core if n.startswith("w_") and n != "w_lsW")
    weight_floats = sum(w[n].numel() for n in core)
    valid = int(np.sum(np.minimum(lengths, S)))
    taps = hp_like.get("ls_kernel", 0) if fused_teacher.is_location_sensitive(hp_like) else 0
    z.update(K=taps, CUM=int(bool(taps) and hp_like.get("ls_cumulative", True)))
    widths = {k: v[1] for k, v in fused_teacher.row_layouts(z, S).items()}
    io_bytes = 2.0 if ops["hp_like"].get("io_dtype") == "bfloat16" else 4.0
    conditioning = B * S * (A + E) + B * z["SPK"]
    outputs = B * N * (z["DU"] + n_src * S)
    if not backward:
        flops = N * (B * 2 * products + valid * (4 * A + 2 * E + 2 * taps * z["A1"]))
        io_values = weight_floats + B * N * z["P2"] + conditioning
        floats = B * S + outputs + B * N * (widths["carry"] + widths["acts"])
    else:
        # location-sensitive: the taps again, w_lsW's gradient and the taps' adjoint
        flops = N * (B * 2 * products + valid * (10 * A + 4 * E + 6 * taps * z["A1"]))
        io_values = weight_floats + B * N * z["P2"] + conditioning + B * N * widths["stack"]
        floats = (B * S + outputs + B * N * (widths["carry"] + widths["acts"])
                  + B * S * A + B * n_src * A + B * widths["stack"] + B * z["SPK"] + n_src * A)
    return float(flops), io_bytes * io_values + 4.0 * floats


def bf16_operands(ops):
    """``ops`` at io_dtype="bfloat16": keys and memories in bfloat16, the rest as it is."""
    out = dict(ops, hp_like=dict(ops["hp_like"], io_dtype="bfloat16"))
    for k in ("keys", "mem1", "mem2"):
        out[k] = None if ops[k] is None else ops[k].to(torch.bfloat16)
    return out


def teacher_run(fn, ops, feeds, prenet_masks, cotangents, seed: int = 1234, **kw):
    """(features, alignments, gradients of every weight, of the conditioning and of
    the feeds, (forward ms, backward ms) on the host clock ending in a synchronise)
    of one call of ``fn`` (``teacher_decode`` or its plain version) under autograd,
    the loss the features and alignments against ``cotangents`` (the alignments'
    None: the loss does not read them, as a training step's does not)."""
    leaf = lambda v: None if v is None else v.detach().clone().requires_grad_(True)  # noqa: E731
    w = {k: leaf(v) for k, v in ops["weights"].items()}
    c = {k: leaf(ops[k]) for k in ("keys", "mem1", "mem2", "spk")}
    f = leaf(feeds)
    (feat, align), fwd_ms = timed_once(lambda: fn(
        weights=w, keys=c["keys"], mem1=c["mem1"], mem2=c["mem2"], spk=c["spk"],
        score_bias=ops["score_bias"], feeds=f, seed=seed, hp_like=ops["hp_like"],
        prenet_masks=prenet_masks, **kw))
    loss = (feat * cotangents[0]).sum()
    if cotangents[1] is not None:
        loss = loss + (align * cotangents[1]).sum()
    _, bwd_ms = timed_once(loss.backward)
    grads = {**{k: v.grad for k, v in w.items()},
             **{k: v.grad for k, v in c.items() if v is not None}, "feeds": f.grad}
    if not ops["hp_like"]["use_ta"]:
        grads.pop("w_ta"), grads.pop("b_ta")        # unused: no gradient, or zeros
    return feat.detach(), align.detach(), grads, (fwd_ms, bwd_ms)


def check_teacher(name, ops, feeds, prenet_masks, lengths, seed=1234, timed=False,
                  tol=TOL_TEACHER, tol_grad=TOL_TEACHER_GRAD, yardstick=False, valid_steps=None):
    """Forward values and every gradient of ``teacher_decode`` (two kernel launches)
    against ``teacher_decode_reference`` under autograd, non-zero cotangents for
    both outputs. At io_dtype="bfloat16" (``bf16_operands``) the outputs and leaves
    are held by ``bf16_shares`` against the plain version's own bfloat16-against-
    float32 gap on the same inputs, and ``tol`` / ``tol_grad`` are not used."""
    B, N = feeds.shape[:2]
    S = ops["keys"].shape[1]
    n_src = 1 if ops["mem2"] is None else 2
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cot_f = torch.randn(B, N, ops["hp_like"]["dec_units"], device=DEV, generator=gen)
    cot_a = torch.randn(B, N, n_src * S, device=DEV, generator=gen)
    if valid_steps is not None:
        # as a loss masks the frames beyond a lane's target length
        live = torch.arange(N, device=DEV)[None, :] < torch.as_tensor(valid_steps, device=DEV)[:, None]
        cot_f, cot_a = cot_f * live[..., None], cot_a * live[..., None]

    def run(fn, with_align=True, moved=1.0, ops_in=None):
        o = ops if ops_in is None else ops_in
        if moved != 1.0:
            o = dict(o, **{k: None if o[k] is None else o[k] * moved
                           for k in ("keys", "mem1", "mem2", "spk")})
        return teacher_run(fn, o, feeds, prenet_masks, (cot_f, cot_a if with_align else None),
                           seed)

    before = (fused_teacher.launch_count, fused_teacher.bwd_launch_count)
    got = run(fused_teacher.teacher_decode)
    launches = (fused_teacher.launch_count - before[0],
                fused_teacher.bwd_launch_count - before[1])
    want = run(fused_teacher.teacher_decode_reference)
    errs = relative_errors(got[2], want[2])
    value_err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    grad_abs = max(max_abs_err(got[2][k], g) for k, g in want[2].items() if g is not None)
    finite = all(bool(torch.isfinite(x).all()) for x in (got[0], got[1], *got[2].values()))
    sums = got[1].reshape(B, N, n_src, S).sum(dim=-1)
    hp_like = ops["hp_like"]
    bf16 = hp_like.get("io_dtype") == "bfloat16"
    gaps = None
    if not bf16:
        within = value_err <= tol and max(errs.values()) <= tol_grad
    else:
        # the yardstick: the plain version in float32 on the same (rounded) inputs
        wide_ops = dict(ops, hp_like=dict(hp_like, io_dtype="float32"))
        for k in ("keys", "mem1", "mem2"):
            wide_ops[k] = None if ops[k] is None else ops[k].float()
        wide = run(fused_teacher.teacher_decode_reference, ops_in=wide_ops)
        outputs = lambda r: {"features": r[0], "alignments": r[1], **r[2]}  # noqa: E731
        gaps = norm_relative(outputs(want), outputs(wide))
        errs_all = norm_relative(outputs(got), outputs(want))
        shares, within = bf16_shares(errs_all, gaps)
    ok = finite and launches == (1, 1) and within and float((sums - 1.0).abs().max()) < 1e-4
    rec = {
        "kernel": "fused_teacher", "case": name, "dual": n_src == 2,
        "shape": {"B": B, "S": S, "N": N, "F": feeds.shape[-1],
                  **{k: int(v) for k, v in hp_like.items() if k.endswith("_units")}},
        "transition_agent": hp_like["use_ta"], "speaker": ops["spk"] is not None,
        "zoneout": [hp_like["zoneout_cell"], hp_like["zoneout_output"]],
        "eval_zoneout": hp_like["eval_zoneout"], "prenet_dropout": prenet_masks is not None,
        "dtype": "bfloat16" if bf16 else "float32",
        "launches_fwd_bwd": list(launches),
        "features_max_abs_err": max_abs_err(got[0], want[0]),
        "alignments_max_abs_err": max_abs_err(got[1], want[1]), "tol": tol,
        "grad_max_rel_err": max(errs.values()), "grad_max_abs_err": grad_abs,
        "tol_grad_rel": tol_grad, "grad_rel_errs": errs,
        "largest_gradient_entry": max(float(g.abs().max()) for g in want[2].values()), "ok": ok,
    }
    if bf16:
        rec.update(tol=None, tol_grad_rel=None, norm_rel_errs=errs_all,
                   bf16_against_f32_norm_rel=gaps, largest_share_of_gap=max(shares.values()),
                   median_share_of_gap=float(np.median(list(shares.values()))))
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
            rec[which] = {
                "ms": kernel_ms[i], "ms_per_step": kernel_ms[i] / N,
                "wrapper_ms": again[3][i], "plain_ms": plain[3][i],
                **bound(flops, nbytes, torch.bfloat16 if bf16 else torch.float32),
                "flops": flops, "bytes": nbytes,
            }
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"fused_teacher disagrees with its plain version: {rec}")
    return rec


def phase_fused_teacher():
    """``fused_teacher`` with two sources against its plain version: narrow and
    off-tile sizes, the trained flagship over 40 and over 400 steps (timed), the
    flagship's widths from seeded weights; then bfloat16, narrow and at the
    flagship's widths from seeded weights (timed). Returns ``{dtype: record}``."""
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
        ops, feeds, masks = teacher_case_inputs(rng, z, lengths, steps, kw)
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
    rec = check_teacher(
        f"flagship B=32 S=128 ragged, {total} steps, trained weights", ops, feeds, masks,
        batch["source_lengths"], timed=True, tol=TOL_TEACHER_TRAINED,
        tol_grad=TOL_TEACHER_TRAINED_GRAD, yardstick=True, valid_steps=valid_steps,
    )
    # bfloat16: narrow cases, then the flagship's widths from seeded weights over all
    # the steps, timed
    for name, z, lengths_n, steps, kw in (
        ("bf16 narrow B=3 S=11", narrow, [11, 7, 4], 6, {}),
        ("bf16 narrow B=5 S=13, transition agent, speaker embedding, train zoneout", narrow,
         [13, 5, 9, 1, 12], 20, dict(use_ta=True, spk=5, zc=0.1, zo=0.1)),
        ("bf16 odd widths B=6 S=7, eval zoneout", odd, [7, 2, 5, 7, 7, 3], 19,
         dict(zc=0.1, zo=0.15, eval_zoneout=True)),
    ):
        ops_n, feeds_n, masks_n = teacher_case_inputs(rng, z, lengths_n, steps, kw)
        check_teacher(name, bf16_operands(ops_n), feeds_n, masks_n, lengths_n)
    rec16 = check_teacher(
        f"bf16 flagship widths, seeded weights, B=32 S=128 ragged, {total} steps",
        bf16_operands(seeded_teacher_operands(rng, wide, 32, 128, lengths, False, 0, 0.1, 0.1,
                                              False)),
        feeds, masks, lengths, timed=True, valid_steps=valid_steps,
    )
    return {"float32": rec, "bfloat16": rec16}


def teacher_case_inputs(rng, z, lengths, steps, kw):
    """Operands, teacher frames and prenet masks of one case at the sizes ``z``."""
    B, S = len(lengths), max(lengths)
    ops = seeded_teacher_operands(
        rng, z, B, S, lengths, kw.get("use_ta", False), kw.get("spk", 0),
        kw.get("zc", 0.0), kw.get("zo", 0.0), kw.get("eval_zoneout", False),
        dual=kw.get("dual", True), ls=kw.get("ls"), taps=kw.get("taps", 31),
    )
    feeds = torch.tensor(rng.standard_normal((B, steps, z["F"])).astype(np.float32), device=DEV)
    masks = None
    if ops["hp_like"]["prenet_drop_rate"] > 0.0:
        masks = tuple(torch.tensor(rng.random((B, steps, z[k])) < 0.5, device=DEV)
                      for k in ("P1", "P2"))
    return ops, feeds, masks


def phase_baseline_teacher():
    """``fused_teacher`` with one source (``dual=False``): narrow and off-tile sizes,
    then the baseline at full width, seeded weights, conditioning from its real
    encoder, 32 x 400 steps with prenet dropout and train zoneout, timed; the same
    in bfloat16 (narrow and at full width, timed). Returns ``{dtype: record}``."""
    narrow = dict(F=10, P1=12, P2=8, AU=12, A1=12, DU=16, E1=12)
    odd = dict(F=7, P1=20, P2=12, AU=28, A1=10, DU=36, E1=20)
    rng = np.random.default_rng(41)
    for name, z, lengths, steps, kw in (
        ("one source, narrow B=3 S=11", narrow, [11, 7, 4], 6, {}),
        ("one source, narrow B=5 S=13, transition agent, speaker embedding, train zoneout",
         narrow, [13, 5, 9, 1, 12], 20, dict(use_ta=True, spk=5, zc=0.1, zo=0.1)),
        ("one source, odd widths B=6 S=7, eval zoneout", odd, [7, 2, 5, 7, 7, 3], 19,
         dict(zc=0.1, zo=0.15, eval_zoneout=True)),
    ):
        ops, feeds, masks = teacher_case_inputs(rng, z, lengths, steps, dict(kw, dual=False))
        check_teacher(name, ops, feeds, masks, lengths)

    net = load_network("baseline", seed=5)
    hp = net.hparams
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
    require(not ops["hp_like"]["dual"] and ops["mem2"] is None, "the baseline has one source")
    total = feeds.shape[1]
    masks = tuple(torch.tensor(rng.random((32, total, u)) < 0.5, device=DEV)
                  for u in hp.decoder_prenet_out_units)
    valid_steps = batch["target_lengths"] // hp.outputs_per_step
    rec = check_teacher(
        f"baseline B=32 S=128 ragged, {total} steps, seeded weights", ops, feeds, masks,
        batch["source_lengths"], timed=True, valid_steps=valid_steps,
    )
    for name, z, lengths, steps, kw in (
        ("bf16 one source, narrow B=5 S=13, transition agent, speaker embedding, train zoneout",
         narrow, [13, 5, 9, 1, 12], 20, dict(use_ta=True, spk=5, zc=0.1, zo=0.1)),
        ("bf16 one source, odd widths B=6 S=7, eval zoneout", odd, [7, 2, 5, 7, 7, 3], 19,
         dict(zc=0.1, zo=0.15, eval_zoneout=True)),
    ):
        ops_n, feeds_n, masks_n = teacher_case_inputs(rng, z, lengths, steps, dict(kw, dual=False))
        check_teacher(name, bf16_operands(ops_n), feeds_n, masks_n, lengths)
    rec16 = check_teacher(
        f"bf16 baseline B=32 S=128 ragged, {total} steps, seeded weights", bf16_operands(ops),
        feeds, masks, batch["source_lengths"], timed=True, valid_steps=valid_steps,
    )
    return {"float32": rec, "bfloat16": rec16}


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


def check_output(out, req, hp: HParams, steps: int = 0) -> None:
    batch, src = req["source"].shape
    steps, r = steps or hp.max_iters, hp.outputs_per_step
    dual = "DualSource" in hp.decoder
    frames = frames_of(out)
    require(frames.shape == (batch, steps * r, frame_width(hp)), f"frames {frames.shape}")
    if hp.decoder.startswith("MgcLf0"):
        require("mel" not in out and out["mgc"].shape[-1] == hp.num_mgcs
                and out["lf0"].shape[-1] == hp.num_lf0s, "the heads mgc and lf0")
    require(out["stop_probs"].shape == (batch, steps * r), "shape of stop_probs")
    require(
        [tuple(a.shape) for a in out["alignments"]] == [(batch, steps, src)] * (2 if dual else 1),
        "shape of alignments",
    )
    if "SelfAttention" in hp.encoder:
        require(
            out["encoder_sa_alignments"][0].shape == (batch, 2, src, src),
            "shape of encoder_sa_alignments",
        )
    else:
        require(out["encoder_sa_alignments"] == (), "a single-stream encoder has no alignments")
    for key, x in (("frames", frames), ("stop_probs", out["stop_probs"])):
        require(bool(torch.isfinite(x).all()), f"{key} is not finite")
    n = int(out["num_steps"])
    require(1 <= n <= steps, f"num_steps {n}")
    for align in out["alignments"]:
        sums = align[:, :n].sum(dim=-1)
        require(float((sums - 1.0).abs().max()) < 1e-4, "alignment rows do not sum to 1")
    for sa in out["encoder_sa_alignments"]:
        sums = sa.sum(dim=-1)
        require(float((sums - 1.0).abs().max()) < 1e-4, "encoder attention rows do not sum to 1")
    lengths = out["lengths"]
    require(int(lengths.min()) >= 1 and int(lengths.max()) <= n * r, "lengths out of range")


def output_errors(out, ref, steps: int, r: int):
    """Max absolute differences over the first ``steps`` decoder steps."""
    errs = {
        "frames": max_abs_err(frames_of(out)[:, : steps * r], frames_of(ref)[:, : steps * r]),
        "stop_probs": max_abs_err(
            out["stop_probs"][:, : steps * r], ref["stop_probs"][:, : steps * r]
        ),
        "alignments": max(
            max_abs_err(a[:, :steps], b[:, :steps])
            for a, b in zip(out["alignments"], ref["alignments"])
        ),
    }
    for a, b in zip(out["encoder_sa_alignments"], ref["encoder_sa_alignments"]):
        errs["encoder_sa_alignments"] = max_abs_err(a, b)
    return errs


def launch_counts():
    return {
        "bigru": fused_rnn.launch_count, "mha_full": fused_attention.launch_count,
        "fused_decode": fused_decode.launch_count, "bilstm": fused_rnn.lstm_launch_count,
    }


def reset_launch_counts():
    fused_rnn.launch_count = fused_rnn.lstm_launch_count = 0
    fused_attention.launch_count = fused_decode.launch_count = 0
    fused_decode.variant_launches.clear()


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
        launch_counts() == {**{name: count + 1 for name, count in before.items()},
                            "bilstm": before["bilstm"]},
        "one request must launch each kernel of the flagship once",
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


def compare_lengths(out, ref, threshold: float, r: int, apart_below_margin: bool = False):
    """Lengths and flags, exactly, on the lanes whose stop probabilities in the
    plain run keep MAIN_MARGIN from the threshold up to and including the frame
    that fires; returns what was left out. With ``apart_below_margin`` (bfloat16,
    whose long runs from the trained weights leave each other's trajectory) a lane
    is held only where, up to that frame, the two runs' stop probabilities also stay
    closer to each other than the plain run's to the threshold: there "fired" cannot
    differ; the other lanes are left out and printed with how far apart they came."""
    probs = ref["stop_probs"].cpu().numpy()
    other = out["stop_probs"].cpu().numpy()
    lengths, fired = ref["lengths"].cpu().numpy(), ref["finished"].cpu().numpy()
    steps = int(ref["num_steps"])
    left_out = []
    for lane in range(probs.shape[0]):
        upto = int(lengths[lane]) if fired[lane] else steps * r
        margin = float(np.abs(probs[lane, :upto] - threshold).min())
        apart = float(np.abs(other[lane, :upto] - probs[lane, :upto]).max())
        if margin < MAIN_MARGIN or (apart_below_margin and apart >= margin):
            left_out.append({
                "lane": lane, "margin": margin, "apart": apart,
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

    reset_launch_counts()
    outs, stats = run_requests(predict, reqs, seed=100)
    launches = launch_counts()
    log("main_path kernels " + json.dumps({
        "launches": launches, "fused_decode_specialisations": fused_decode.variant_launches,
        "requests": stats,
    }))
    expected = {"bigru": len(reqs), "mha_full": len(reqs), "fused_decode": len(reqs), "bilstm": 0}
    require(launches == expected, f"the main path launched {launches}, expected {expected}")
    for out, req in zip(outs, reqs):
        check_output(out, req, hp)

    # eager encoder and the step-by-step decode loop: no kernel at all
    hp_plain = flagship_hparams(use_pallas_kernels=False)
    predict_plain = make_predict_fn(convert.load_npz(NPZ, hp_plain), max_iters=hp.max_iters)
    before = launch_counts()
    outs_plain, stats_plain = run_requests(predict_plain, reqs, seed=100)
    require(before == launch_counts(), "the plain path launched a kernel")
    log("main_path plain " + json.dumps({"requests": stats_plain}))
    compare_paths(outs, outs_plain, hp)
    phase_against_cpu()
    return launches, stats, stats_plain, outs


def compare_paths(outs, outs_plain, hp, label: str = "") -> None:
    """Kernel path against plain path, request by request, as set out at MAIN_MARGIN."""
    r = hp.outputs_per_step
    for out, ref in zip(outs, outs_plain):
        left_out = compare_lengths(out, ref, hp.stop_token_threshold, r)
        steps = min(int(out["num_steps"]), int(ref["num_steps"]))
        whole = output_errors(out, ref, steps, r)
        early = output_errors(out, ref, min(EARLY_STEPS, steps), r)
        log(f"main_path agreement{label} " + json.dumps({
            "batch": int(out["lengths"].shape[0]),
            "num_steps": [int(out["num_steps"]), int(ref["num_steps"])],
            "lanes_left_out_of_the_exact_comparison": left_out, "margin": MAIN_MARGIN,
            "early_steps": EARLY_STEPS, "early": early, "early_tol": TOL_MAIN_EARLY,
            "whole": whole, "whole_tol": TOL_MAIN,
        }))
        if not max(early.values()) <= TOL_MAIN_EARLY:
            raise SystemExit(f"kernel path and plain path differ early: {early}")
        if not max(whole.values()) <= TOL_MAIN:
            raise SystemExit(f"kernel path and plain path differ: {whole}")


def bf16_against_cpu(steps: int = 30) -> dict:
    """A short bfloat16 request: the card's kernel path against the port on the CPU
    taking the fused decode's plain version (which rounds where the kernel does),
    same weights, source and injected masks, encoder prenet dropout off, no exit."""
    hp = flagship_hparams(compute_dtype="bfloat16", encoder_prenet_drop_rate=0.0,
                          stop_token_threshold=2.0)
    rng = np.random.default_rng(78)
    req = ragged_request(rng, 2, 40)
    masks = tuple(
        rng.random((steps, 2, units)) < 1.0 - hp.decoder_prenet_drop_rate
        for units in hp.decoder_prenet_out_units
    )
    on_card = make_predict_fn(convert.load_npz(NPZ, hp), max_iters=steps)(req, prenet_masks=masks)
    on_cpu = make_predict_fn(convert.load_npz(NPZ, hp, device="cpu"), max_iters=steps,
                             device="cpu", use_fused=True)(req, prenet_masks=masks)
    card = {
        k: tuple(x.cpu() for x in v) if isinstance(v, tuple) else v.cpu()
        for k, v in on_card.items()
    }
    errs = output_errors(card, on_cpu, steps, hp.outputs_per_step)
    log("main_path bf16 card_vs_cpu " + json.dumps({"steps": steps, **errs, "tol": TOL_CPU_BF16}))
    if int(card["num_steps"]) != steps or not torch.equal(card["lengths"], on_cpu["lengths"]):
        raise SystemExit("bfloat16: the card and the CPU disagree on the steps or the lengths")
    if not max(errs.values()) <= TOL_CPU_BF16:
        raise SystemExit(f"bfloat16: the card and the CPU differ: {errs}")
    return errs


def phase_main_path_bf16(outs_f32):
    """Flagship synthesis at compute_dtype="bfloat16" from the trained weights,
    batch 1 and 32, through the kernels (``bigru`` and ``mha_full`` in bfloat16,
    ``fused_decode``'s bfloat16 branch) and with ``use_pallas_kernels=False``, same
    generator seed: launch counts exact, lengths and flags on the lanes with a
    margin; the floats of the two paths, and the drift from the float32 requests
    of ``phase_main_path`` (same requests, same seeds), printed."""
    reqs = requests()
    hp = flagship_hparams(compute_dtype="bfloat16")
    predict = make_predict_fn(convert.load_npz(NPZ, hp), max_iters=hp.max_iters)
    run_requests(predict, reqs[:1], seed=0)            # warm-up

    reset_launch_counts()
    outs, stats = run_requests(predict, reqs, seed=100)
    launches = launch_counts()
    variants = dict(fused_decode.variant_launches)
    log("main_path bf16 kernels " + json.dumps({
        "launches": launches, "fused_decode_specialisations": variants, "requests": stats,
    }))
    expected = {"bigru": len(reqs), "mha_full": len(reqs), "fused_decode": len(reqs), "bilstm": 0}
    require(launches == expected, f"the bf16 main path launched {launches}, expected {expected}")
    require(variants == {fused_decode.variant_name(True, True, torch.bfloat16): len(reqs)},
            f"the bf16 main path launched the specialisations {variants}")
    for out, req in zip(outs, reqs):
        check_output(out, req, hp)
        require(out["mel"].dtype == torch.float32 and out["stop_probs"].dtype == torch.float32,
                "the bfloat16 outputs must come back in float32")

    hp_plain = flagship_hparams(compute_dtype="bfloat16", use_pallas_kernels=False)
    predict_plain = make_predict_fn(convert.load_npz(NPZ, hp_plain), max_iters=hp.max_iters)
    before = launch_counts()
    outs_plain, stats_plain = run_requests(predict_plain, reqs, seed=100)
    require(before == launch_counts(), "the bf16 plain path launched a kernel")
    log("main_path bf16 plain " + json.dumps({"requests": stats_plain}))
    r = hp.outputs_per_step
    for out, ref, out32 in zip(outs, outs_plain, outs_f32):
        left_out = compare_lengths(out, ref, hp.stop_token_threshold, r, apart_below_margin=True)
        steps = min(int(out["num_steps"]), int(ref["num_steps"]))
        log("main_path bf16 agreement " + json.dumps({
            "batch": int(out["mel"].shape[0]),
            "lanes_held": int(out["mel"].shape[0]) - len(left_out),
            "num_steps": [int(out["num_steps"]), int(ref["num_steps"])],
            "lanes_left_out_of_the_exact_comparison": left_out, "margin": MAIN_MARGIN,
            "early_steps": EARLY_STEPS,
            "early": output_errors(out, ref, min(EARLY_STEPS, steps), r),
            "whole": output_errors(out, ref, steps, r),
        }))
        steps32 = min(int(out["num_steps"]), int(out32["num_steps"]))
        log("main_path bf16 against float32 (printed, not compared) " + json.dumps({
            "batch": int(out["mel"].shape[0]),
            "num_steps": {"bfloat16": int(out["num_steps"]), "float32": int(out32["num_steps"])},
            "early": output_errors(out, out32, min(EARLY_STEPS, steps32), r),
            "whole": output_errors(out, out32, steps32, r),
            "lengths": {"bfloat16": out["lengths"].tolist(),
                        "float32": out32["lengths"].tolist()},
            "finished": {"bfloat16": int(out["finished"].sum()),
                         "float32": int(out32["finished"].sum())},
        }))
    cpu_errs = bf16_against_cpu()
    return launches, stats, stats_plain, cpu_errs


# The baseline's zoneout request decodes this many steps on both paths.
ZONEOUT_STEPS = 100


def phase_baseline_main_path():
    """Baseline synthesis at full width from seeded weights (no trained weights of
    the family are committed), batch 1 and batch 32, through the kernels and with
    ``use_pallas_kernels=False``, same generator seed. Seeded weights have no
    trained stop token: the threshold is out of reach and every request decodes to
    the cap, so that every lane's length and flag is held exactly. Then one
    ZoneoutEncoderV1 request of batch 32, whose encoder is ``bilstm``."""
    reqs = requests()
    overrides = dict(stop_token_threshold=2.0)
    net = load_network("baseline", seed=11, **overrides)
    hp = net.hparams
    predict = make_predict_fn(net, max_iters=hp.max_iters)
    run_requests(predict, reqs[:1], seed=0)            # warm-up
    reset_launch_counts()
    outs, stats = run_requests(predict, reqs, seed=100)
    launches = launch_counts()
    variants = dict(fused_decode.variant_launches)
    log("main_path baseline kernels " + json.dumps({
        "launches": launches, "fused_decode_specialisations": variants, "requests": stats,
    }))
    expected = {"bigru": len(reqs), "mha_full": 0, "fused_decode": len(reqs), "bilstm": 0}
    require(launches == expected, f"baseline synthesis launched {launches}, expected {expected}")
    require(variants == {fused_decode.variant_name(False, False): len(reqs)},
            f"baseline synthesis launched the specialisations {variants}")
    for out, req in zip(outs, reqs):
        check_output(out, req, hp)
    predict_plain = make_predict_fn(
        load_network("baseline", seed=11, use_pallas_kernels=False, **overrides),
        max_iters=hp.max_iters,
    )
    before = launch_counts()
    outs_plain, stats_plain = run_requests(predict_plain, reqs, seed=100)
    require(before == launch_counts(), "the plain path launched a kernel")
    log("main_path baseline plain " + json.dumps({"requests": stats_plain}))
    compare_paths(outs, outs_plain, hp, label=" baseline")

    # ZoneoutEncoderV1: the same decoder behind the bidirectional ZoneoutLSTM
    req = requests()[1]
    zoneout = load_network("zoneout", seed=12, **overrides)
    predict = make_predict_fn(zoneout, max_iters=ZONEOUT_STEPS)
    run_requests(predict, [req], seed=0)               # warm-up
    reset_launch_counts()
    out, zstats = run_requests(predict, [req], seed=200)
    zlaunches = launch_counts()
    log("main_path zoneout kernels " + json.dumps({"launches": zlaunches, "requests": zstats}))
    expected = {"bigru": 0, "mha_full": 0, "fused_decode": 1, "bilstm": 1}
    require(zlaunches == expected, f"the ZoneoutEncoderV1 request launched {zlaunches}")
    check_output(out[0], req, zoneout.hparams, steps=ZONEOUT_STEPS)
    out_plain, _ = run_requests(
        make_predict_fn(load_network("zoneout", seed=12, use_pallas_kernels=False, **overrides),
                        max_iters=ZONEOUT_STEPS),
        [req], seed=200,
    )
    compare_paths(out, out_plain, zoneout.hparams, label=" zoneout")
    return {"launches": launches, "variants": variants, "stats": stats,
            "stats_plain": stats_plain, "zoneout_launches": zlaunches}


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
        "bilstm": fused_rnn.lstm_launch_count,
    }


def reset_training_counts():
    reset_launch_counts()
    fused_rnn.bwd_launch_count = 0
    fused_teacher.launch_count = fused_teacher.bwd_launch_count = 0
    fused_teacher.variant_launches.clear()


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
                 trace: bool = False, config: str = "flagship"):
    """``steps`` updates of ``config`` from ``make_net(hp)`` with the launch counts
    read around them. ``measure``: a warm-up on a state of its own and an
    evaluation step first; ``trace``: one more step under ``torch.profiler`` after."""
    hp = config_hparams(config, **overrides)
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
    variants = {"_".join(k): v for k, v in fused_teacher.variant_launches.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    finite = all(np.isfinite(v) for m in metrics for v in m.values())
    busy = None
    if trace and finite:
        busy = device_busy(lambda: trainer.train_step(state, batch, gen),
                           sum(r["wall_ms"] for r in rows[1:]) / (steps - 1), top=6)
    log(f"training {path} " + json.dumps({
        "card": gpu_line(), "batch": int(batch["done"].shape[0]),
        "frames_per_lane": int(batch["done"].shape[1]), "valid_frames": frames,
        "launches": counts, "fused_teacher_specialisations": variants, "steps": rows,
        "metrics": metrics, "eval": eval_losses,
        "eval_launches": eval_counts, "max_memory_allocated_gb": peak_gb, "device": busy,
    }))
    require(finite, f"{path}: a metric is not finite")
    moved = 0
    for name, p in state.net.named_parameters():
        require(bool(torch.isfinite(p).all()), f"{path}: {name} is not finite after training")
        moved += bool((p != start[name]).any())
    require(moved == len(start), f"{path}: only {moved} of {len(start)} parameters changed")
    require(state.step == steps, "the state must count the steps")
    return {"metrics": metrics, "rows": rows, "counts": counts, "variants": variants,
            "peak_gb": peak_gb,
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


def check_seeded_agreement(label: str, kernels, plain, **extra) -> None:
    """From seeded weights every gradient leaf of the first step is held (see
    TOL_TRAIN_LEAF_REL), with the loss parts and grad_norm."""
    row = first_step_agreement(kernels, plain)
    log(f"training agreement, {label} " + json.dumps({
        **row, "tol_loss": TOL_TRAIN_LOSS, "tol_grad_norm_rel": TOL_TRAIN_NORM_REL,
        "tol_leaf_rel": TOL_TRAIN_LEAF_REL, **extra,
    }))
    if not (max(row["loss_parts_abs"].values()) <= TOL_TRAIN_LOSS
            and row["grad_norm_rel"] <= TOL_TRAIN_NORM_REL
            and row["gradient_leaves_max_rel_err"] <= TOL_TRAIN_LEAF_REL):
        raise SystemExit(f"kernel path and plain path differ from {label}: {row}")


def phase_training():
    hp = flagship_hparams()
    batch = training_batch(np.random.default_rng(1234), 32, 800, 128, hp.num_mels,
                           hp.outputs_per_step)
    one_step = {"bigru": 1, "bigru_bwd": 1, "fused_teacher_fwd": 1, "fused_teacher_bwd": 1,
                "mha_full": 0, "fused_decode": 0, "bilstm": 0}
    plain_hp = {"use_pallas_kernels": False}

    # (a) one step from freshly initialised weights at full width: every gradient leaf
    seeded = run_training("kernels, seeded weights", batch, {}, seeded_network, 1, False)
    require(seeded["counts"] == one_step, f"one step launched {seeded['counts']}")
    seeded_plain = run_training("plain, seeded weights", batch, plain_hp, seeded_network, 1, False)
    check_seeded_agreement("seeded weights", seeded, seeded_plain)
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


def phase_training_bf16():
    """``phase_training`` at compute_dtype="bfloat16", the reference's training dtype:
    (a) one step from seeded weights through the kernels (their bfloat16 branches)
    and through the plain path, every gradient leaf printed in ||delta|| / ||ref||
    beside the yardstick, the plain path in bfloat16 against the plain path in
    float32 from the same weights; the kernel path must not be further from the
    plain path than that (the median leaf, and the loss parts); (b) three steps from
    the trained weights through the kernels and three on the plain path, launch
    counts exact, finite metrics, every parameter moved; an evaluation step on both."""
    hp = flagship_hparams(compute_dtype="bfloat16")
    batch = training_batch(np.random.default_rng(1234), 32, 800, 128, hp.num_mels,
                           hp.outputs_per_step)
    one_step = {"bigru": 1, "bigru_bwd": 1, "fused_teacher_fwd": 1, "fused_teacher_bwd": 1,
                "mha_full": 0, "fused_decode": 0, "bilstm": 0}
    bf16 = {"compute_dtype": "bfloat16"}
    plain = {"compute_dtype": "bfloat16", "use_pallas_kernels": False}

    # (a) one step from freshly initialised weights at full width
    seeded = run_training("bf16 kernels, seeded weights", batch, bf16, seeded_network, 1, False)
    require(seeded["counts"] == one_step, f"one bf16 step launched {seeded['counts']}")
    seeded_plain = run_training("bf16 plain, seeded weights", batch, plain, seeded_network, 1,
                                False)
    require(all(v == 0 for v in seeded_plain["counts"].values()),
            "the plain path launched a kernel")
    seeded_f32 = run_training("float32 plain, seeded weights", batch,
                              {"use_pallas_kernels": False}, seeded_network, 1, False)
    grads = [r["first_grads"] for r in (seeded, seeded_plain, seeded_f32)]
    against_plain = norm_relative(grads[0], grads[1])
    yardstick = norm_relative(grads[1], grads[2])
    against_f32 = norm_relative(grads[0], grads[2])
    shares = {k: against_plain[k] / max(yardstick[k], 1e-30) for k in yardstick}
    m_k, m_p, m_f = (r["metrics"][0] for r in (seeded, seeded_plain, seeded_f32))
    loss_rows = {k: {"kernels_against_plain": abs(m_k[k] - m_p[k]),
                     "plain_bf16_against_f32": abs(m_p[k] - m_f[k]),
                     "kernels_against_f32": abs(m_k[k] - m_f[k])} for k in m_p}
    median_share = float(np.median(list(shares.values())))
    log("training agreement, bf16 seeded weights " + json.dumps({
        "loss_parts": loss_rows, "median_leaf_share_of_yardstick": median_share,
        "largest_leaf_share_of_yardstick": max(shares.values()),
        "median_leaf_kernels_against_f32_share_of_yardstick": float(np.median(
            [against_f32[k] / max(yardstick[k], 1e-30) for k in yardstick])),
        "leaves": {k: {"kernels_against_plain": against_plain[k],
                       "plain_bf16_against_f32": yardstick[k],
                       "kernels_against_f32": against_f32[k]}
                   for k in sorted(yardstick, key=lambda k: -shares[k])},
    }))
    require(median_share <= 1.0,
            f"bf16 kernel path further from the plain path than bf16 from float32: {median_share}")
    for k, row in loss_rows.items():
        if k != "grad_norm":
            require(row["kernels_against_plain"] <= max(row["plain_bf16_against_f32"], 1e-4),
                    f"bf16 loss part {k}: {row}")
    del seeded, seeded_plain, seeded_f32
    torch.cuda.empty_cache()

    # (b) three steps from the trained weights
    kernels = run_training("bf16 kernels", batch, bf16, trained_network, TRAIN_STEPS, True,
                           trace=True)
    expected = {k: TRAIN_STEPS * v for k, v in one_step.items()}
    require(kernels["counts"] == expected,
            f"{TRAIN_STEPS} bf16 training steps launched {kernels['counts']}, expected {expected}")
    require(kernels["eval_counts"] == {**one_step, "bigru_bwd": 0, "fused_teacher_bwd": 0,
                                       "mha_full": 1},
            f"a bf16 evaluation step launched {kernels['eval_counts']}")
    torch.cuda.empty_cache()
    plain_run = run_training("bf16 plain", batch, plain, trained_network, TRAIN_STEPS, True)
    require(all(v == 0 for v in plain_run["counts"].values()), "the plain path launched a kernel")
    require(all(v == 0 for v in plain_run["eval_counts"].values()),
            "the plain path launched a kernel")
    log("training bf16 paths " + json.dumps({
        "loss_parts_per_step": [{"kernels": a, "plain": b}
                                for a, b in zip(kernels["metrics"], plain_run["metrics"])],
        "eval": {"kernels": kernels["eval"], "plain": plain_run["eval"]},
    }))
    return kernels, plain_run


def phase_baseline_training():
    """The baseline's ``train_step`` at full width, 32 lanes x 800 frames, from
    seeded weights (the same on both paths): three timed steps through the kernels
    (the one-source teacher kernels, ``bigru_train``), launch counts exact, and one
    step with ``use_pallas_kernels=False``, every gradient leaf of the first step
    held; an evaluation step on both paths."""
    hp = config_hparams("baseline")
    batch = training_batch(np.random.default_rng(1234), 32, 800, 128, hp.num_mels,
                           hp.outputs_per_step)
    one_step = {"bigru": 1, "bigru_bwd": 1, "fused_teacher_fwd": 1, "fused_teacher_bwd": 1,
                "mha_full": 0, "fused_decode": 0, "bilstm": 0}
    kernels = run_training("baseline kernels, seeded weights", batch, {}, seeded_network,
                           TRAIN_STEPS, True, trace=True, config="baseline")
    expected = {k: TRAIN_STEPS * v for k, v in one_step.items()}
    require(kernels["counts"] == expected,
            f"{TRAIN_STEPS} baseline steps launched {kernels['counts']}, expected {expected}")
    require(kernels["variants"] == {"fwd_single": TRAIN_STEPS, "bwd_single": TRAIN_STEPS},
            f"the baseline launched the teacher specialisations {kernels['variants']}")
    require(kernels["eval_counts"] == {**one_step, "bigru_bwd": 0, "fused_teacher_bwd": 0},
            f"a baseline evaluation step launched {kernels['eval_counts']}")
    torch.cuda.empty_cache()
    plain = run_training("baseline plain, seeded weights", batch, {"use_pallas_kernels": False},
                         seeded_network, 1, True, config="baseline")
    require(all(v == 0 for v in plain["counts"].values()), "the plain path launched a kernel")
    require(all(v == 0 for v in plain["eval_counts"].values()), "the plain path launched a kernel")
    eval_diffs = {k: abs(v - plain["eval"][k]) for k, v in kernels["eval"].items()}
    check_seeded_agreement("baseline, seeded weights", kernels, plain,
                           eval_loss_parts_abs=eval_diffs, tol_eval=TOL_EVAL)
    if not max(eval_diffs.values()) <= TOL_EVAL:
        raise SystemExit(f"baseline kernel path and plain path differ in evaluation: {eval_diffs}")
    return kernels, plain


# --------------------------------------------------------------------------- #
# The location-sensitive branch of the three loop kernels: the `ls` family
# --------------------------------------------------------------------------- #

LS = {"attention": "location_sensitive"}
# The span, in logits, that the main path spreads a seeded ``ls`` decoder's stop
# logits to (they lie within a few hundredths of each other), centred on the
# threshold 0.5: wide enough that most lanes keep MAIN_MARGIN from it up to their
# firing frame.
def phase_ls_decode():
    """``fused_decode``'s location-sensitive instantiations against their plain
    version: at narrow and off-tile sizes (7 and 31 taps, cumulative and previous
    alignments, one source and two with self-attention, ragged lanes shorter than
    the source), float32 to the cap and with early exits, bfloat16 to the cap (the
    narrow seeded decoders' stop logits lie closer together than BF16_MARGIN_FACTOR
    times a bfloat16 run's error, so "fired" could differ at any threshold; the
    bfloat16 exit is held on the main path, ``phase_ls_main_path``); at full width
    from seeded weights with conditioning from the real encoder: ``ls`` B=32
    (ragged 24..128) with an early exit in float32, and over 500 steps B=32 and
    B=1 in both io types; ``flagship-ls`` B=32 over 500 steps in both io types
    (the reference trains that case in bfloat16). Returns ``{(config, dtype, batch):
    record}``."""
    rng = np.random.default_rng(51)
    single = {"encoder": "EncoderV1", "decoder": "ExtendedDecoder"}
    narrow = dict(LS, attention_filters=4)
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        for case, (name, overrides, lengths, src_len) in enumerate((
            ("ExtendedDecoder B=5 S=13, 7 taps, cumulative",
             dict(single, attention_kernel=7), [13, 5, 9, 1, 12], 13),
            ("ExtendedDecoder B=6 S=40, 31 taps, previous alignments",
             dict(single, cumulative_weights=False), [40, 12, 33, 5, 40, 27], 40),
            ("DualSourceSelfAttentionDecoder B=3 S=11, 7 taps, previous alignments",
             dict(attention_kernel=7, cumulative_weights=False), [11, 7, 4], 11),
            ("DualSourceSelfAttentionDecoder B=5 S=37, 31 taps, cumulative",
             {}, [37, 20, 9, 37, 2], 37),
        )):
            hp = narrow_hparams(**narrow, **overrides, compute_dtype=dtype)
            decoder = seeded_decoder(hp, seed=60 + case)
            cond = seeded_conditioning(decoder, rng, lengths, src_len)
            masks = seeded_masks(fused_decode.pack_decoder(decoder), rng, 24, len(lengths))
            if bf16:
                check_fused(f"ls bfloat16 narrow {name}, to the cap",
                            fused_decode.pack_decoder(decoder), cond, masks, 24, 2.0,
                            tol=TOL_FUSED_BF16)
                continue
            factor = spread_for_exit(decoder, cond, masks, 24)
            check_fused_with_exit(f"ls float32 narrow {name}, stop rows x {factor}",
                                  fused_decode.pack_decoder(decoder), cond, rng, 24, masks=masks)

    records = {}
    for config, dtype, seed in (("ls", "float32", 52), ("ls", "bfloat16", 52),
                                ("flagship-ls", "float32", 53), ("flagship-ls", "bfloat16", 53)):
        bf16 = dtype == "bfloat16"
        net = load_network(config, seed=seed, compute_dtype=dtype)
        packed = fused_decode.pack_decoder(net.decoder)
        require(packed.ls and packed.sizes["K"] == 31, f"{config}: 31 location taps")
        steps = net.hparams.max_iters
        for batch, longest in ((32, 128), (1, 97)):
            if config == "flagship-ls" and batch == 1:
                continue
            req = ragged_request(rng, batch, longest)
            cond = flagship_conditioning(net, req, seed=batch)
            label = f"{config} {dtype} B={batch} S={longest}"
            if config == "ls" and batch == 32 and not bf16:
                # seeded weights never stop: the early exit is held with the stop rows spread
                masks = seeded_masks(packed, rng, FUSED_STEPS, batch)
                factor = spread_for_exit(net.decoder, cond, masks, FUSED_STEPS)
                check_fused_with_exit(
                    f"{label}, stop rows x {factor}", fused_decode.pack_decoder(net.decoder),
                    cond, rng, FUSED_STEPS, masks=masks)
                spread_stop_logits(net.decoder, 1.0 / factor)
            masks = seeded_masks(packed, rng, steps, batch)
            records[(config, dtype, batch)] = time_fused(
                f"{label}, {steps} steps, time", packed, cond, masks, req["source_lengths"], steps)
    return records


def teacher_batch(config: str, dtype: str, seed: int):
    """(operands, teacher frames, prenet masks, source lengths, valid steps) of one
    training batch (32 x 800 frames, ``config``'s heads) through the seeded network
    of ``config``."""
    net = load_network(config, seed=seed, compute_dtype=dtype)
    hp = net.hparams
    batch = config_batch(hp, np.random.default_rng(1234))
    tensors = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    with torch.no_grad():
        cond, _ = net.encode(
            tensors["source"], tensors["source_lengths"],
            generator=torch.Generator(device=DEV).manual_seed(0),
        )
        net.decoder.train()
        ops = net.decoder.teacher_operands(cond)
        feeds = net.decoder.make_teacher_feeds(
            targets_from_batch(tacotron_model_factory(hp), tensors))
    rng = np.random.default_rng(seed)
    masks = tuple(torch.tensor(rng.random((32, feeds.shape[1], u)) < 0.5, device=DEV)
                  for u in hp.decoder_prenet_out_units)
    return (ops, feeds, masks, batch["source_lengths"],
            batch["target_lengths"] // hp.outputs_per_step)


def phase_ls_teacher():
    """``fused_teacher``'s location-sensitive instantiations (forward and backward)
    against autograd through the plain version, every gradient (``w_lsW`` and
    ``ls_bias`` among them): narrow and off-tile sizes (7 and 31 taps, cumulative
    and previous alignments, one source and two, zoneout, a speaker embedding) in
    float32 and bfloat16; at full width over 400 steps with conditioning from the
    real encoder, prenet dropout and train zoneout: ``ls`` and ``flagship-ls`` in
    both io types, timed. Returns ``{(config, dtype): record}``."""
    narrow = dict(F=10, P1=12, P2=8, AU=12, A1=12, A2=6, DU=16, E1=12, E2=8)
    odd = dict(F=7, P1=20, P2=12, AU=28, A1=10, A2=7, DU=36, E1=20, E2=12)
    rng = np.random.default_rng(54)
    cases = (
        ("one source, narrow B=3 S=11, 7 taps, cumulative", narrow, [11, 7, 4], 6,
         dict(dual=False, ls="cum", taps=7)),
        ("one source, odd widths B=6 S=40, 31 taps, previous alignments, train zoneout", odd,
         [40, 12, 33, 5, 40, 27], 19, dict(dual=False, ls="prev", zc=0.3, zo=0.2)),
        ("two sources, narrow B=5 S=13, 7 taps, previous alignments, speaker embedding", narrow,
         [13, 5, 9, 1, 12], 20, dict(ls="prev", taps=7, spk=5)),
        ("two sources, odd widths B=5 S=37, 31 taps, cumulative, eval zoneout", odd,
         [37, 20, 9, 37, 2], 19, dict(ls="cum", zc=0.1, zo=0.15, eval_zoneout=True)),
    )
    for dtype in ("float32", "bfloat16"):
        for name, z, lengths, steps, kw in cases:
            ops, feeds, masks = teacher_case_inputs(rng, z, lengths, steps, kw)
            check_teacher(f"ls {dtype} {name}", bf16_operands(ops) if dtype == "bfloat16" else ops,
                          feeds, masks, lengths)
    records = {}
    for config, dtype in (("ls", "float32"), ("ls", "bfloat16"), ("flagship-ls", "float32"),
                          ("flagship-ls", "bfloat16")):
        ops, feeds, masks, lengths, valid_steps = teacher_batch(config, dtype, seed=55)
        require(fused_teacher.is_location_sensitive(ops["hp_like"])
                and ops["hp_like"]["ls_kernel"] == 31, f"{config}: 31 location taps")
        records[(config, dtype)] = check_teacher(
            f"{config} {dtype} B=32 S=128 ragged, {feeds.shape[1]} steps, seeded weights", ops,
            feeds, masks, lengths, timed=True, valid_steps=valid_steps)
    return records


# --------------------------------------------------------------------------- #
# The WORLD-feature family (MgcLf0): the lf0 softmax feedback of fused_decode,
# and the teacher kernels' batch blocks
# --------------------------------------------------------------------------- #

# The narrow WORLD heads: the split (num_mgcs) and the frame's end off a multiple of 4.
NARROW_WORLD = {"num_mgcs": 7, "num_lf0s": 13}
# Seeds of weights a narrow early-exit check may take before it fails.
EXIT_SEEDS = 5


def phase_mgclf0_decode():
    """``fused_decode``'s lf0 branch (the fed-back frame's lf0 lanes softmaxed)
    against its plain version, on its first launches: the four MgcLf0 decoders (every
    pair of ``dual`` / ``use_sa``) at narrow and off-tile sizes (the split at 7 or 5
    lanes, frames of 20 and 19; a transition agent, a speaker embedding, r=3, lanes
    shorter than the source), float32 and bfloat16, each to the cap and with an
    early exit (lengths, flags, step counts and the zero tail exact), and as
    sequential batch blocks; then at full width from seeded weights, conditioning
    from the real encoder, frames of 316 (mgc 60, lf0 256): ``mgclf0`` B=32 (ragged
    24..128) with an early exit in float32, and over 500 steps B=32 and B=1 in both
    io types, ``flagship-mgclf0`` over 500 steps B=32 and B=1, timed (float32 held
    on every step, bfloat16 by FUSED_BF16_WINDOWS). Returns ``{(config, dtype,
    batch): record}``."""
    single = {"encoder": "EncoderV1"}
    odd = {"decoder_prenet_drop_rate": 0.0, "decoder_prenet_out_units": (20, 12),
           "attention_out_units": 28, "attention1_out_units": 10, "decoder_out_units": 36,
           "decoder_self_attention_out_units": 24, "num_mgcs": 5, "num_lf0s": 14,
           "outputs_per_step": 3, "cbhg_out_units": 20}
    steps = 24
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        for case, (name, overrides, lengths, src_len, spk) in enumerate((
            ("MgcLf0DualSourceSelfAttentionDecoder B=3 S=11",
             {"decoder": "MgcLf0DualSourceSelfAttentionDecoder"}, [11, 7, 4], 11, 0),
            ("MgcLf0DualSourceDecoder B=5 S=13, transition agent",
             {"decoder": "MgcLf0DualSourceDecoder", "attention": "forward_transition_agent"},
             [13, 5, 9, 1, 12], 13, 0),
            ("MgcLf0ExtendedDecoder B=5 S=9, speaker embedding",
             {**single, "decoder": "MgcLf0ExtendedDecoder", "use_speaker_embedding": True,
              "num_speakers": 4, "speaker_embedding_dim": 6}, [9, 9, 3, 6, 2], 9, 6),
            ("MgcLf0SelfAttentionDecoder B=6 S=7 r=3, odd widths, prenet dropout 0",
             {**single, **odd, "decoder": "MgcLf0SelfAttentionDecoder"},
             [7, 2, 5, 7, 7, 3], 7, 0),
        )):
            rng = np.random.default_rng(81 + case)
            hp = narrow_hparams(**{**NARROW_WORLD, **overrides, "compute_dtype": dtype})
            # seeded stop logits crowd together: where the widest gap between them is
            # under the margin that an exit needs (a bfloat16 run's error times
            # BF16_MARGIN_FACTOR), the next seed's weights, each held to the cap first
            for attempt in range(EXIT_SEEDS):
                decoder = seeded_decoder(hp, seed=80 + len(lengths) + src_len + 100 * attempt)
                cond = seeded_conditioning(decoder, rng, lengths, src_len, spk)
                masks = seeded_masks(fused_decode.pack_decoder(decoder), rng, steps,
                                     len(lengths))
                factor = spread_for_exit(decoder, cond, masks, steps)
                packed = fused_decode.pack_decoder(decoder)
                require(packed.sizes["LF0"] == hp.num_mgcs
                        and packed.sizes["M"] == hp.num_mgcs + hp.num_lf0s,
                        f"{name}: the lf0 lanes of the frame")
                held = check_fused_with_exit(
                    f"lf0 {dtype} narrow {name}, weights {attempt}, stop rows x {factor}",
                    packed, cond, rng, steps, masks=masks,
                    tol=TOL_FUSED_BF16 if bf16 else TOL_FUSED,
                    margin_factor=BF16_MARGIN_FACTOR if bf16 else FUSED_MARGIN_FACTOR,
                    gap_required=attempt == EXIT_SEEDS - 1)
                if held is not None:
                    break
        check_fused(f"lf0 {dtype} narrow B=6, two batch blocks", packed, cond,
                    seeded_masks(packed, rng, steps, 6), steps, 2.0, slice_batch=4,
                    tol=TOL_FUSED_BF16 if bf16 else TOL_FUSED)

    records = {}
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    rng = np.random.default_rng(82)
    for config, dtype, seed in (("mgclf0", "float32", 83), ("mgclf0", "bfloat16", 83),
                                ("flagship-mgclf0", "float32", 84)):
        net = load_network(config, seed=seed, compute_dtype=dtype)
        hp, packed = net.hparams, fused_decode.pack_decoder(net.decoder)
        steps = hp.max_iters
        need, have = fused_decode.block_shared_memory(packed.sizes, 128, steps, DEV,
                                                      packed.io_dtype)
        limit = fused_decode.fused_decode_max_batch(hp, steps, 128)
        log("check " + json.dumps({
            "kernel": "fused_decode", "case": f"{config} {dtype}: launch limit",
            "M": packed.sizes["M"], "LF0": packed.sizes["LF0"], "block_needs": need,
            "sm_offers": have, "lanes_per_launch": limit}))
        require(packed.sizes["M"] == 316 and packed.sizes["LF0"] == 60,
                f"{config}: frames of mgc 60 and lf0 256")
        require(limit == fused_decode.MAX_LANES, f"{config}: the launch limit is {limit}")
        for batch, longest in ((32, 128), (1, 97)):
            req = ragged_request(rng, batch, longest)
            cond = flagship_conditioning(net, req, seed=batch)
            label = f"{config} {dtype} B={batch} S={longest}"
            if config == "mgclf0" and batch == 32 and dtype == "float32":
                # seeded weights never stop: the early exit is held with the stop rows spread
                masks = seeded_masks(packed, rng, FUSED_STEPS, batch)
                factor = spread_for_exit(net.decoder, cond, masks, FUSED_STEPS)
                check_fused_with_exit(
                    f"{label}, stop rows x {factor}", fused_decode.pack_decoder(net.decoder),
                    cond, rng, FUSED_STEPS, masks=masks)
                spread_stop_logits(net.decoder, 1.0 / factor)
            masks = seeded_masks(packed, rng, steps, batch)
            records[(config, dtype, batch)] = time_fused(
                f"{label}, {steps} steps, time", packed, cond, masks, req["source_lengths"], steps)
        del net, packed
    return records


def teacher_agreement(got, want):
    return {"values_max_abs_err": max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])),
            "grad_max_rel_err": max(relative_errors(got[2], want[2]).values())}


def check_teacher_blocks(name, ops, feeds, prenet_masks, lengths, valid_steps, block: int):
    """``teacher_decode`` in sequential batch blocks of ``block`` lanes (a batch
    beyond one launch; block i's zoneout seed is seed + i * BLOCK_SEED_STRIDE) at
    full width: with zoneout 0 against the unsliced kernels, and with train zoneout
    against the plain version's per-block runs (``teacher_decode_reference`` with the
    same ``slice_batch``); values and every gradient at TOL_TEACHER /
    TOL_TEACHER_GRAD, a launch pair per block. The blocked call and the unsliced
    one are timed on the host clock, prenet and gradient products included."""
    B, N = feeds.shape[:2]
    S = ops["keys"].shape[1]
    blocks = -(-B // block)
    gen = torch.Generator(device=DEV).manual_seed(7)
    live = torch.arange(N, device=DEV)[None, :] < torch.as_tensor(valid_steps, device=DEV)[:, None]
    n_src = 1 if ops["mem2"] is None else 2
    cot = (torch.randn(B, N, ops["hp_like"]["dec_units"], device=DEV, generator=gen)
           * live[..., None],
           torch.randn(B, N, n_src * S, device=DEV, generator=gen) * live[..., None])
    still = dict(ops, hp_like=dict(ops["hp_like"], zoneout_cell=0.0, zoneout_output=0.0))
    require(ops["hp_like"]["zoneout_cell"] > 0.0 and not ops["hp_like"]["eval_zoneout"],
            f"{name}: the per-block runs need train zoneout")
    launches = []
    runs = {}
    for key, o, fn, kw in (
        ("blocked, zoneout 0", still, fused_teacher.teacher_decode, {"slice_batch": block}),
        ("unsliced, zoneout 0", still, fused_teacher.teacher_decode, {}),
        ("blocked, train zoneout", ops, fused_teacher.teacher_decode, {"slice_batch": block}),
        ("per-block plain runs, train zoneout", ops, fused_teacher.teacher_decode_reference,
         {"slice_batch": block}),
        ("unsliced, train zoneout", ops, fused_teacher.teacher_decode, {}),
    ):
        before = (fused_teacher.launch_count, fused_teacher.bwd_launch_count)
        runs[key] = teacher_run(fn, o, feeds, prenet_masks, cot, **kw)
        launches.append((key, fused_teacher.launch_count - before[0],
                         fused_teacher.bwd_launch_count - before[1]))
    still_err = teacher_agreement(runs["blocked, zoneout 0"], runs["unsliced, zoneout 0"])
    train_err = teacher_agreement(runs["blocked, train zoneout"],
                                  runs["per-block plain runs, train zoneout"])
    # the blocks' own seeds: their masks are not those of one launch
    seeds_differ = max_abs_err(runs["blocked, train zoneout"][0][block:],
                               runs["unsliced, train zoneout"][0][block:])
    expected = {"blocked, zoneout 0": blocks, "unsliced, zoneout 0": 1,
                "blocked, train zoneout": blocks, "per-block plain runs, train zoneout": 0,
                "unsliced, train zoneout": 1}
    finite = all(bool(torch.isfinite(x).all()) for r in runs.values() for x in (r[0], r[1]))
    ok = (finite and all(f == b == expected[k] for k, f, b in launches)
          and still_err["values_max_abs_err"] <= TOL_TEACHER
          and still_err["grad_max_rel_err"] <= TOL_TEACHER_GRAD
          and train_err["values_max_abs_err"] <= TOL_TEACHER
          and train_err["grad_max_rel_err"] <= TOL_TEACHER_GRAD and seeds_differ > 1e-3)
    rec = {
        "kernel": "fused_teacher", "case": name, "B": B, "N": N, "S": S, "block": block,
        "blocks": blocks, "launches_fwd_bwd": {k: [f, b] for k, f, b in launches},
        "blocked_against_unsliced_zoneout_0": still_err,
        "blocked_against_per_block_plain_runs": train_err,
        "blocked_against_unsliced_train_zoneout_features": seeds_differ,
        "tol": TOL_TEACHER, "tol_grad_rel": TOL_TEACHER_GRAD,
        "wall_ms_fwd_bwd": {k: list(r[3]) for k, r in runs.items()}, "ok": ok,
    }
    for i, which in enumerate(("fwd", "bwd")):
        flops, nbytes = teacher_flops_and_bytes(ops, feeds, lengths, backward=bool(i))
        rec[which] = {
            "ms": runs["blocked, train zoneout"][3][i],
            "unsliced_ms": runs["unsliced, train zoneout"][3][i],
            "plain_ms": runs["per-block plain runs, train zoneout"][3][i],
            **bound(flops, nbytes, torch.float32), "flops": flops, "bytes": nbytes,
        }
    log("check " + json.dumps(rec))
    if not ok:
        raise SystemExit(f"fused_teacher in batch blocks disagrees: {rec}")
    return rec


def phase_mgclf0_teacher():
    """The teacher kernels under the WORLD heads (their feeds 316 wide through the
    hoisted prenet; the kernels themselves are the mel family's): ``mgclf0`` at full
    width over 400 steps against the plain version, every gradient, timed; then the
    teacher kernels in three sequential batch blocks (12, 12 and 8 lanes) at the
    same width (``check_teacher_blocks``). Returns ``{("mgclf0", "float32"): record,
    "blocks": record}``."""
    ops, feeds, masks, lengths, valid_steps = teacher_batch("mgclf0", "float32", seed=85)
    require(feeds.shape[-1] == 316, f"mgclf0 feeds {tuple(feeds.shape)}")
    rec = check_teacher(f"mgclf0 float32 B=32 S=128 ragged, {feeds.shape[1]} steps, seeded "
                        "weights", ops, feeds, masks, lengths, timed=True, valid_steps=valid_steps)
    blocks = check_teacher_blocks(
        f"mgclf0 float32 B=32 S=128 ragged, {feeds.shape[1]} steps, three batch blocks", ops,
        feeds, masks, lengths, valid_steps, block=12)
    return {("mgclf0", "float32"): rec, "blocks": blocks}


# --------------------------------------------------------------------------- #
# The families served from seeded weights: main path and training
# --------------------------------------------------------------------------- #

# (one-source configuration, two-source configuration, location-sensitive, the io
# types the two-source configuration runs in: the reference trains flagship-ls in
# bfloat16 too, scripts/tpu_parity.py:377-382)
FAMILIES = {
    "ls": ("ls", "flagship-ls", True, ("float32", "bfloat16")),
    "mgclf0": ("mgclf0", "flagship-mgclf0", False, ("float32",)),
}
# Seeded stop rows never fire: on the main path they are spread so that a run of the
# one-source configuration's batch-32 request to the cap spans this much in logits.
SEEDED_STOP_SPAN = 20.0


def seeded_main_path(family: str):
    """Synthesis of ``family``'s configurations through ``make_predict_fn`` from
    seeded weights, batch 1 and 32, through the kernels and with
    ``use_pallas_kernels=False``, same generator seed, in float32 and in bfloat16:
    the one-source configuration (``bilstm`` and ``fused_decode``), then the
    two-source one to the cap (``bigru``, ``mha_full``, ``fused_decode``). Seeded
    weights never stop: the one-source configuration's stop rows are spread as
    ``phase_baseline_decode`` spreads them, here so that a run of the batch-32
    request to the cap spans SEEDED_STOP_SPAN in logits, centred on the threshold
    0.5 at the median lane, so that about half its lanes fire, at steps of their
    own. Launch counts exact, lengths and flags on the lanes with a margin (float32
    as ``compare_paths`` holds them, bfloat16 as ``phase_main_path_bf16``); a short
    request of the one-source configuration on the card against the same on the
    CPU in both io types. Returns ``{(config, dtype): {"launches", "variants",
    "stats", "stats_plain", "threshold"}}``."""
    single, dual_config, ls, dual_dtypes = FAMILIES[family]
    reqs = requests()
    out = {}
    for config, dtype in ((single, "float32"), (single, "bfloat16"),
                          *((dual_config, d) for d in dual_dtypes)):
        bf16 = dtype == "bfloat16"
        threshold, factor, shift = 2.0, 1.0, 0.0

        def network(**overrides):
            net = load_network(config, seed=61, compute_dtype=dtype,
                               **{"stop_token_threshold": threshold, **overrides})
            shape_stop_rows(net.decoder, factor, shift)
            return net

        if config == single:
            # the batch-32 request (its masks as run_requests draws them) to the cap:
            # its stop rows are scaled so that its stop logits span SEEDED_STOP_SPAN and
            # shifted so that the median of the lanes' largest logit lands on 0 (they
            # feed nothing back, so the run moves by exactly that map); at the
            # threshold 0.5 about half the lanes fire, the others run to the cap
            steps = config_hparams(config).max_iters
            to_cap = make_predict_fn(network(stop_token_threshold=2.0), max_iters=steps)(
                reqs[1], generator=torch.Generator(device=DEV).manual_seed(301))
            logits = stop_logits(to_cap["stop_probs"])
            span = float(logits.max() - logits.min())
            factor = SEEDED_STOP_SPAN / span
            shift = factor * float(np.median(logits.max(axis=1)))
            threshold = 0.5
            log(f"main_path {config} {dtype} stop rows " + json.dumps(
                {"threshold": threshold, "scaled_by": factor, "shifted_by": -shift,
                 "stop_logits_span_before": span}))
        net = network()
        hp = net.hparams
        predict = make_predict_fn(net, max_iters=hp.max_iters)
        run_requests(predict, reqs[:1], seed=0)            # warm-up
        reset_launch_counts()
        outs, stats = run_requests(predict, reqs, seed=300)
        launches = launch_counts()
        variants = dict(fused_decode.variant_launches)
        log(f"main_path {config} {dtype} kernels " + json.dumps({
            "launches": launches, "fused_decode_specialisations": variants, "requests": stats}))
        dual = config == dual_config
        expected = {"bigru": len(reqs) if dual else 0, "mha_full": len(reqs) if dual else 0,
                    "fused_decode": len(reqs), "bilstm": 0 if dual else len(reqs)}
        require(launches == expected, f"{config} {dtype} synthesis launched {launches}")
        name = fused_decode.variant_name(dual, dual, COMPUTE[dtype], ls=ls, lf0=not ls)
        require(variants == {name: len(reqs)}, f"{config} {dtype} launched {variants}")
        for o, req in zip(outs, reqs):
            check_output(o, req, hp)
        predict_plain = make_predict_fn(network(use_pallas_kernels=False), max_iters=hp.max_iters)
        before = launch_counts()
        outs_plain, stats_plain = run_requests(predict_plain, reqs, seed=300)
        require(before == launch_counts(), "the plain path launched a kernel")
        log(f"main_path {config} {dtype} plain " + json.dumps({"requests": stats_plain}))
        r = hp.outputs_per_step
        if not bf16:
            compare_paths(outs, outs_plain, hp, label=f" {config}")
        else:
            for o, ref in zip(outs, outs_plain):
                left_out = compare_lengths(o, ref, hp.stop_token_threshold, r,
                                           apart_below_margin=True)
                steps = min(int(o["num_steps"]), int(ref["num_steps"]))
                log(f"main_path {config} bf16 agreement " + json.dumps({
                    "batch": int(o["lengths"].shape[0]),
                    "lanes_held": int(o["lengths"].shape[0]) - len(left_out),
                    "num_steps": [int(o["num_steps"]), int(ref["num_steps"])],
                    "lanes_left_out_of_the_exact_comparison": left_out, "margin": MAIN_MARGIN,
                    "early": output_errors(o, ref, min(EARLY_STEPS, steps), r),
                    "whole": output_errors(o, ref, steps, r),
                }))
        if config == single:
            seeded_against_cpu(config, network, dtype, factor, shift)
        out[(config, dtype)] = {"launches": launches, "variants": variants, "stats": stats,
                                "stats_plain": stats_plain, "threshold": threshold}
    return out


COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def seeded_against_cpu(config: str, network, dtype: str, factor: float, shift: float,
                       steps: int = 30) -> None:
    """A short request of ``config`` on the card (the kernels) against the same on
    the CPU (float32: the step-by-step path; bfloat16: the fused decode's plain
    version), same weights, source and injected masks, no exit."""
    bf16 = dtype == "bfloat16"
    rng = np.random.default_rng(79)
    req = ragged_request(rng, 2, 40)
    # no encoder prenet dropout: the card's and the CPU's generators differ
    card_net = network(stop_token_threshold=2.0, encoder_prenet_drop_rate=0.0)
    hp = card_net.hparams
    masks = tuple(rng.random((steps, 2, units)) < 1.0 - hp.decoder_prenet_drop_rate
                  for units in hp.decoder_prenet_out_units)
    on_card = make_predict_fn(card_net, max_iters=steps)(req, prenet_masks=masks)
    cpu_net = load_network(config, seed=61, device="cpu", compute_dtype=dtype,
                           stop_token_threshold=2.0, encoder_prenet_drop_rate=0.0)
    shape_stop_rows(cpu_net.decoder, factor, shift)
    on_cpu = make_predict_fn(cpu_net, max_iters=steps, device="cpu",
                             use_fused=True if bf16 else None)(req, prenet_masks=masks)
    card = {k: tuple(x.cpu() for x in v) if isinstance(v, tuple) else v.cpu()
            for k, v in on_card.items()}
    errs = output_errors(card, on_cpu, steps, hp.outputs_per_step)
    tol = TOL_CPU_BF16 if bf16 else TOL_CPU
    log(f"main_path {config} {dtype} card_vs_cpu " + json.dumps(
        {"steps": steps, **errs, "tol": tol}))
    if int(card["num_steps"]) != steps or not torch.equal(card["lengths"], on_cpu["lengths"]):
        raise SystemExit(f"{config} {dtype}: the card and the CPU disagree on the steps or lengths")
    if not max(errs.values()) <= tol:
        raise SystemExit(f"{config} {dtype}: the card and the CPU differ: {errs}")


def phase_ls_main_path():
    return seeded_main_path("ls")


def phase_mgclf0_main_path():
    return seeded_main_path("mgclf0")


def seeded_training(family: str):
    """``train_step`` of ``family``'s configurations at full width, 32 lanes x 800
    frames (the configuration's heads), from seeded weights: (a) the one-source
    configuration in float32, three timed steps through the kernels (the one-source
    teacher kernels; ZoneoutEncoderV1 trains through its plain LSTM) and one with
    ``use_pallas_kernels=False``, every gradient leaf of the first step held (the
    location-sensitive family: ``location_conv``, ``location_layer`` and
    ``attention_b`` among them, which must not be zero), launch counts exact, an
    evaluation step on both; (b) the same in bfloat16 (the plain path one step, no
    evaluation), the first step's leaves beside the yardstick of the plain path in
    bfloat16 against the plain path in float32 (the median leaf held); (c) the
    two-source configuration: one step, kernels against plain, every leaf held in
    float32, and (where the family trains it so) in bfloat16 beside its yardstick."""
    single, dual_config, ls, dual_dtypes = FAMILIES[family]
    suffix = "_ls" if ls else ""
    batch = config_batch(config_hparams(single), np.random.default_rng(1234))
    one_step = {"bigru": 0, "bigru_bwd": 0, "fused_teacher_fwd": 1, "fused_teacher_bwd": 1,
                "mha_full": 0, "fused_decode": 0, "bilstm": 0}
    # an evaluation step: the teacher forward, and ZoneoutEncoderV1's eval kernel
    eval_step = {**one_step, "fused_teacher_bwd": 0, "bilstm": 1}
    plain = {"use_pallas_kernels": False}

    def special_leaves(grads):
        if not ls:
            return []
        keys = [k for k in grads if "location_conv" in k or "location_layer" in k
                or k.endswith("attention_b")]
        require(len(keys) == 4 and all(float(grads[k].abs().max()) > 0.0 for k in keys),
                "the location parameters must receive gradients")
        return keys

    def against_yardstick(label, kernels, plain_run, f32_plain, extra):
        grads = [r["first_grads"] for r in (kernels, plain_run, f32_plain)]
        against_plain = norm_relative(grads[0], grads[1])
        yardstick = norm_relative(grads[1], grads[2])
        shares = {k: against_plain[k] / max(yardstick[k], 1e-30) for k in yardstick}
        median_share = float(np.median(list(shares.values())))
        log(f"training agreement, {label} " + json.dumps({
            "median_leaf_share_of_yardstick": median_share,
            "largest_leaf_share_of_yardstick": max(shares.values()),
            "leaves": {k: {"kernels_against_plain": against_plain[k],
                           "plain_bf16_against_f32": yardstick[k]}
                       for k in special_leaves(grads[0])}, **extra,
        }))
        require(median_share <= 1.0, f"{label}: the kernel path is further from the plain path "
                f"than bf16 from float32: {median_share}")

    results = {}
    for dtype in ("float32", "bfloat16"):
        overrides = {"compute_dtype": dtype}
        kernels = run_training(f"{single} {dtype} kernels, seeded weights", batch, overrides,
                               seeded_network, TRAIN_STEPS, True, trace=True, config=single)
        expected = {k: TRAIN_STEPS * v for k, v in one_step.items()}
        require(kernels["counts"] == expected, f"{TRAIN_STEPS} {single} {dtype} steps launched "
                f"{kernels['counts']}, expected {expected}")
        require(kernels["variants"] == {f"fwd_single{suffix}": TRAIN_STEPS,
                                        f"bwd_single{suffix}": TRAIN_STEPS},
                f"{single} {dtype} launched the teacher specialisations {kernels['variants']}")
        require(kernels["eval_counts"] == eval_step,
                f"a {single} {dtype} evaluation step launched {kernels['eval_counts']}")
        torch.cuda.empty_cache()
        # float32: with a warm-up and an evaluation step, which are held; bfloat16 one
        # step, held beside its yardstick
        plain_run = run_training(f"{single} {dtype} plain, seeded weights", batch,
                                 dict(overrides, **plain), seeded_network, 1,
                                 dtype == "float32", config=single)
        require(all(v == 0 for v in plain_run["counts"].values()), "the plain path launched a kernel")
        require(all(v == 0 for v in plain_run["eval_counts"].values()),
                "the plain path launched a kernel")
        special_leaves(kernels["first_grads"])
        if dtype == "float32":
            eval_diffs = {k: abs(v - plain_run["eval"][k]) for k, v in kernels["eval"].items()}
            check_seeded_agreement(f"{single}, seeded weights", kernels, plain_run,
                                   eval_loss_parts_abs=eval_diffs, tol_eval=TOL_EVAL)
            if not max(eval_diffs.values()) <= TOL_EVAL:
                raise SystemExit(f"{single} kernel path and plain path differ in evaluation: "
                                 f"{eval_diffs}")
            f32_plain = plain_run
        else:
            against_yardstick(f"{single} bf16 seeded weights", kernels, plain_run, f32_plain, {})
        results[dtype] = (kernels, plain_run)
        torch.cuda.empty_cache()

    # (c) the two-source configuration: one step on both paths in each io type
    fl_one = {**one_step, "bigru": 1, "bigru_bwd": 1}
    for dtype in dual_dtypes:
        overrides = {"compute_dtype": dtype}
        fl_kernels = run_training(f"{dual_config} {dtype} kernels, seeded weights", batch,
                                  overrides, seeded_network, 1, False, config=dual_config)
        require(fl_kernels["counts"] == fl_one,
                f"one {dual_config} {dtype} step launched {fl_kernels['counts']}")
        require(fl_kernels["variants"] == {f"fwd_dual{suffix}": 1, f"bwd_dual{suffix}": 1},
                f"{dual_config} launched the teacher specialisations {fl_kernels['variants']}")
        fl_plain = run_training(f"{dual_config} {dtype} plain, seeded weights", batch,
                                dict(overrides, **plain), seeded_network, 1, False,
                                config=dual_config)
        if dtype == "float32":
            check_seeded_agreement(f"{dual_config}, seeded weights", fl_kernels, fl_plain)
            fl_f32_plain = fl_plain
        else:
            against_yardstick(f"{dual_config} bf16 seeded weights", fl_kernels, fl_plain,
                              fl_f32_plain, {})
        results[(dual_config, dtype)] = (fl_kernels, fl_plain)
        torch.cuda.empty_cache()
    return results


def phase_ls_training():
    return seeded_training("ls")


def phase_mgclf0_training():
    return seeded_training("mgclf0")


def family_kernel_entries(family: str, decode, teacher, main_path, train):
    """The ``kernels`` entries of ``family``'s instantiations: times at full width
    from the kernel phases, launches from the family's main paths (synthesis in each
    io type, training steps)."""
    single, dual_config, ls, _ = FAMILIES[family]
    tag = "ls" if ls else "lf0"
    entries = []
    for config, dtype in ((single, "float32"), (single, "bfloat16"), (dual_config, "float32"),
                          (dual_config, "bfloat16")):
        if (config, dtype, 32) not in decode:
            continue
        dual = config == dual_config
        rec = decode[(config, dtype, 32)]
        io = "float" if dtype == "float32" else "__nv_bfloat16"
        run = main_path[(config, dtype)]
        flags = (f"{str(dual).lower()}, {str(dual).lower()}, {str(ls).lower()}, "
                 f"{str(not ls).lower()}, false, {io}")
        entry = {
            "name": f"fused_decode{'_dual' if dual else ''}_{tag}"
                    + ("_bf16" if dtype == "bfloat16" else ""),
            "route": "cuda", "source": "self_attention_tacotron_torch/csrc/fused_decode.cu",
            "replaces": "self_attention_tacotron_tpu/ops/fused_decode.py:787", "design": DECODE_DESIGN,
            "instantiation": f"fused_decode_kernel<{flags}>",
            "launches": run["variants"].get(fused_decode.variant_name(
                dual, dual, COMPUTE[dtype], ls=ls, lf0=not ls), 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
            "shape": rec["shape"] | {"T": rec["steps_timed"]}, "dtype": dtype,
            "ms_per_step": rec["ms_per_step"], "config": config,
            "fused_request_ms": 1e3 * run["stats"][1]["wall_s"],
            "step_by_step_request_ms": 1e3 * run["stats_plain"][1]["wall_s"],
        }
        if not ls:
            entry["lf0_lanes"] = [rec["shape"]["LF0"], rec["shape"]["M"]]
        if (config, dtype, 1) in decode:
            b1 = decode[(config, dtype, 1)]
            entry.update(batch1_ms=b1["ms"], batch1_ms_per_step=b1["ms_per_step"],
                         batch1_bound_ms=b1["bound_ms"], batch1_plain_ms=b1["plain_ms"])
        entries.append(entry)
    for which, line in (("fwd", 1219), ("bwd", 1310)):
        for config, dtype in ((single, "float32"), (single, "bfloat16"),
                              (dual_config, "float32"), (dual_config, "bfloat16")):
            if (config, dtype) not in teacher:
                continue
            dual = config == dual_config
            rec = teacher[(config, dtype)]
            io = "float" if dtype == "float32" else "__nv_bfloat16"
            steps = train[dtype if not dual else (config, dtype)][0]
            err = (max(rec["features_max_abs_err"], rec["alignments_max_abs_err"])
                   if which == "fwd" else rec["grad_max_abs_err"])
            entry = {
                "name": f"fused_teacher_{which}{'_dual' if dual else ''}_{tag}"
                        + ("_bf16" if dtype == "bfloat16" else ""),
                "route": "cuda", "source": "self_attention_tacotron_torch/csrc/fused_teacher.cu",
                "replaces": f"self_attention_tacotron_tpu/ops/fused_teacher.py:{line}",
                "instantiation": f"teacher_{which}_kernel<{str(dual).lower()}, "
                                 f"{str(ls).lower()}, {io}>",
                "launches": steps["counts"][f"fused_teacher_{which}"],
                "max_abs_err": err, "ms": rec[which]["ms"], "plain_ms": rec[which]["plain_ms"],
                "bound_ms": rec[which]["bound_ms"], "bound_by": rec[which]["bound_by"],
                "library_ms": None, "shape": rec["shape"], "dtype": dtype, "config": config,
                "ms_per_step": rec[which]["ms_per_step"], "wrapper_ms": rec[which]["wrapper_ms"],
                "grad_max_rel_err": rec["grad_max_rel_err"],
                "train_step_ms": min(r["step_ms"] for r in steps["rows"]),
            }
            if not ls:
                # the teacher kernels' launches on each of the family's training paths
                # (each io type and source count has its instantiation), and the path
                # of a batch beyond one launch: sequential batch blocks
                entry["family_launches"] = {
                    " ".join(key) if isinstance(key, tuple) else f"{single} {key}":
                        run_["counts"][f"fused_teacher_{which}"]
                    for key, (run_, _) in train.items()}
                blocks = teacher["blocks"]
                entry["batch_blocks"] = {
                    "blocks": blocks["blocks"], "block": blocks["block"],
                    "launches": blocks["launches_fwd_bwd"]["blocked, train zoneout"][
                        0 if which == "fwd" else 1],
                    "wall_ms": blocks[which]["ms"],
                    "unsliced_wall_ms": blocks[which]["unsliced_ms"],
                    "plain_ms": blocks[which]["plain_ms"], "bound_ms": blocks[which]["bound_ms"],
                    "bound_by": blocks[which]["bound_by"],
                    "against_unsliced_zoneout_0": blocks["blocked_against_unsliced_zoneout_0"],
                    "against_per_block_plain_runs": blocks["blocked_against_per_block_plain_runs"],
                }
            entries.append(entry)
    return entries


def main() -> int:
    started = time.perf_counter()
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = cuda_build.build_all()
    log(f"build: {len(cuda_build.KERNEL_SOURCES)} kernels with nvcc in {build_s:.1f} s "
        f"-> {os.path.relpath(cuda_build.BUILD_DIR, REPO)}")

    use_full_float32()

    def timed_phase(phase, *args):
        begin = time.perf_counter()
        result = phase(*args)
        log(f"phase {phase.__name__}: {time.perf_counter() - begin:.1f} s")
        return result

    records = timed_phase(phase_kernels)
    fused = timed_phase(phase_fused_decode)
    fused_bf16 = timed_phase(phase_fused_decode_bf16)
    baseline_fused = timed_phase(phase_baseline_decode)
    bigru_bwd_dtypes = timed_phase(phase_bigru_bwd)
    teacher_dtypes = timed_phase(phase_fused_teacher)
    baseline_teacher_dtypes = timed_phase(phase_baseline_teacher)
    bigru_bwd, teacher, baseline_teacher = (
        r["float32"] for r in (bigru_bwd_dtypes, teacher_dtypes, baseline_teacher_dtypes))
    launches, stats, stats_plain, outs_f32 = timed_phase(phase_main_path)
    launches_bf16, stats_bf16, stats_plain_bf16, _ = timed_phase(phase_main_path_bf16, outs_f32)
    del outs_f32
    baseline = timed_phase(phase_baseline_main_path)
    train, train_plain = timed_phase(phase_training)
    baseline_train, baseline_train_plain = timed_phase(phase_baseline_training)
    train_bf16, train_plain_bf16 = timed_phase(phase_training_bf16)
    ls_decode = timed_phase(phase_ls_decode)
    ls_teacher = timed_phase(phase_ls_teacher)
    ls_main = timed_phase(phase_ls_main_path)
    ls_train = timed_phase(phase_ls_training)
    world_decode = timed_phase(phase_mgclf0_decode)
    world_teacher = timed_phase(phase_mgclf0_teacher)
    world_main = timed_phase(phase_mgclf0_main_path)
    world_train = timed_phase(phase_mgclf0_training)

    replaces = {
        "bigru": "self_attention_tacotron_tpu/ops/fused_rnn.py:101",
        "mha_full": "self_attention_tacotron_tpu/ops/fused_attention.py:84",
        "bilstm": "self_attention_tacotron_tpu/ops/fused_rnn.py:461",
    }
    # launches on the main paths: flagship synthesis in float32 and in bfloat16
    # (bigru, mha_full, fused_decode), baseline synthesis (bigru, fused_decode) and
    # the ZoneoutEncoderV1 request (bilstm); fused_decode's bfloat16 instantiation
    # has an entry of its own
    main_launches = {
        k: launches[k] + baseline["launches"][k] + baseline["zoneout_launches"][k]
        + (launches_bf16[k] if k != "fused_decode" else 0)
        for k in launches
    }
    kernels = []
    for name in ("bigru", "mha_full", "bilstm"):
        rec = records[(name, torch.float32)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"self_attention_tacotron_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": main_launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
            "shape": rec["shape"], "dtype": rec["dtype"],
            "bf16_ms": records[(name, torch.bfloat16)]["ms"],
            "bf16_max_abs_err": records[(name, torch.bfloat16)]["max_abs_err"],
            "bf16_bound_ms": records[(name, torch.bfloat16)]["bound_ms"],
            "bf16_plain_ms": records[(name, torch.bfloat16)]["plain_ms"],
            "bf16_main_path_launches": launches_bf16[name],
        })
    # the BiGRU's forward kernel is also the primal of the training function
    kernels[0].update(
        also_replaces="self_attention_tacotron_tpu/ops/fused_rnn.py:216",
        training_launches=train["counts"]["bigru"] + baseline_train["counts"]["bigru"],
        bf16_training_launches=train_bf16["counts"]["bigru"],
    )
    # torch.nn.LSTM (cuDNN) has no zoneout interpolation: another function, no library time
    kernels[2]["zoneout"] = records[("bilstm", torch.float32)]["zoneout"]
    # the whole loop in one launch at the main path's shapes: flagship, B=32, T=500;
    # the baseline's specialisation (one source, no self-attention) beside it.
    # No single PyTorch call computes a decode loop, so there is no library time;
    # the step-by-step path's wall time for the batch-32 request stands beside it.
    rec, base = fused[32], baseline_fused[32]
    specialisations = {
        fused_decode.variant_name(True, True): launches["fused_decode"],
        fused_decode.variant_name(False, False): (
            baseline["launches"]["fused_decode"] + baseline["zoneout_launches"]["fused_decode"]
        ),
    }
    instantiations = [
        f"fused_decode_kernel<{dual}, {use_sa}, false, false, false, {io}>"
        for io in ("float", "__nv_bfloat16") for dual in ("true", "false")
        for use_sa in ("true", "false")
    ]
    long_cap = {
        f"{label}, B={batch}": {k: cap[k] for k in ("ms", "ms_per_step", "launches")}
        | {"windows_max": [w["max"] for w in cap["windows"]]}
        for (label, batch), cap in fused["long_cap"].items()
    }
    unrun = {
        f"{key[0]}, {key[1]}": {k: fused_bf16[key][k] for k in (
            "ms", "ms_per_step", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
        for key in fused_bf16 if isinstance(key, tuple)
    }
    kernels.append({
        "name": "fused_decode", "route": "cuda",
        "source": "self_attention_tacotron_torch/csrc/fused_decode.cu",
        "replaces": "self_attention_tacotron_tpu/ops/fused_decode.py:787", "design": DECODE_DESIGN,
        "launches": main_launches["fused_decode"], "specialisations": specialisations,
        "instantiations": instantiations,
        "specialisations_checked": ["dual=1,use_sa=1", "dual=1,use_sa=0", "dual=0,use_sa=0",
                                    "dual=0,use_sa=1"],
        "flagship_widths_unrun_specialisations_B32_T500": unrun,
        f"step_cap_{LONG_CAP}": long_cap,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        "shape": rec["shape"] | {"T": rec["steps_timed"]}, "dtype": "float32",
        "ms_per_step": rec["ms_per_step"], "compared_over_steps": FUSED_STEPS,
        "stage_us_step_250": {f"B={b}": fused[b]["stage_us"]["250"] for b in (32, 1)},
        "batch1_ms": fused[1]["ms"], "batch1_ms_per_step": fused[1]["ms_per_step"],
        "batch1_bound_ms": fused[1]["bound_ms"], "batch1_plain_ms": fused[1]["plain_ms"],
        "step_by_step_request_ms": 1e3 * stats_plain[1]["wall_s"],
        "step_by_step_ms_per_step": stats_plain[1]["ms_per_step"],
        "fused_request_ms": 1e3 * stats[1]["wall_s"],
        "baseline": {
            "variant": base["variant"], "ms": base["ms"], "ms_per_step": base["ms_per_step"],
            "plain_ms": base["plain_ms"], "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"], "max_abs_err": base["max_abs_err"],
            "batch1_ms": baseline_fused[1]["ms"],
            "batch1_ms_per_step": baseline_fused[1]["ms_per_step"],
            "batch1_bound_ms": baseline_fused[1]["bound_ms"],
            "batch1_plain_ms": baseline_fused[1]["plain_ms"],
            "fused_request_ms": 1e3 * baseline["stats"][1]["wall_s"],
            "step_by_step_request_ms": 1e3 * baseline["stats_plain"][1]["wall_s"],
        },
    })
    b16 = fused_bf16[32]
    kernels.append({
        "name": "fused_decode_bf16", "route": "cuda",
        "source": "self_attention_tacotron_torch/csrc/fused_decode.cu",
        "replaces": "self_attention_tacotron_tpu/ops/fused_decode.py:787", "design": DECODE_DESIGN,
        "instantiation": "fused_decode_kernel<true, true, false, false, false, __nv_bfloat16>",
        "launches": launches_bf16["fused_decode"],
        "max_abs_err": b16["max_abs_err"], "ms": b16["ms"], "plain_ms": b16["plain_ms"],
        "bound_ms": b16["bound_ms"], "bound_by": b16["bound_by"], "library_ms": None,
        "shape": b16["shape"] | {"T": b16["steps_timed"]}, "dtype": "bfloat16",
        "ms_per_step": b16["ms_per_step"], "compared_over_steps": BF16_EARLY_STEPS,
        "median_lane_err": b16["median_lane_err"],
        "tol": TOL_FUSED_BF16_WIDE,
        "stage_us_step_250": {f"B={b}": fused_bf16[b]["stage_us"]["250"] for b in (32, 1)},
        "batch1_ms": fused_bf16[1]["ms"], "batch1_ms_per_step": fused_bf16[1]["ms_per_step"],
        "batch1_bound_ms": fused_bf16[1]["bound_ms"], "batch1_plain_ms": fused_bf16[1]["plain_ms"],
        "fused_request_ms": 1e3 * stats_bf16[1]["wall_s"],
        "step_by_step_request_ms": 1e3 * stats_plain_bf16[1]["wall_s"],
    })
    # The training kernels: launches are those of the training steps of both
    # configurations. No single PyTorch call computes any of them (``torch.nn.GRU``
    # has another candidate, and nothing computes a teacher-forced attention
    # decoder), so there is no library time; the all-plain path's training step
    # stands beside the kernel path's.
    step_ms = {
        "train_step_ms": min(r["step_ms"] for r in train["rows"]),
        "plain_train_step_ms": min(r["step_ms"] for r in train_plain["rows"]),
        "baseline_train_step_ms": min(r["step_ms"] for r in baseline_train["rows"]),
        "baseline_plain_train_step_ms": min(r["step_ms"] for r in baseline_train_plain["rows"]),
    }
    kernels.append({
        "name": "bigru_bwd", "route": "cuda",
        "source": "self_attention_tacotron_torch/csrc/bigru_bwd.cu",
        "replaces": "self_attention_tacotron_tpu/ops/fused_rnn.py:293",
        "launches": train["counts"]["bigru_bwd"] + baseline_train["counts"]["bigru_bwd"],
        "max_abs_err": bigru_bwd["max_abs_err"],
        "ms": bigru_bwd["ms"], "plain_ms": bigru_bwd["plain_ms"],
        "bound_ms": bigru_bwd["bound_ms"], "bound_by": bigru_bwd["bound_by"],
        "library_ms": None, "shape": bigru_bwd["shape"], "dtype": "float32",
        "grad_max_rel_err": bigru_bwd["grad_max_rel_err"],
        "train_fwd_bwd_ms": bigru_bwd["train_fwd_bwd_ms"],
        "plain_fwd_bwd_ms": bigru_bwd["plain_fwd_bwd_ms"], **step_ms,
    })
    for which, line in (("fwd", 1219), ("bwd", 1310)):
        errs = {
            label: (max(t["features_max_abs_err"], t["alignments_max_abs_err"])
                    if which == "fwd" else t["grad_max_abs_err"])
            for label, t in (("dual", teacher), ("single", baseline_teacher))
        }
        base = baseline_teacher[which]
        kernels.append({
            "name": f"fused_teacher_{which}", "route": "cuda",
            "source": "self_attention_tacotron_torch/csrc/fused_teacher.cu",
            "replaces": f"self_attention_tacotron_tpu/ops/fused_teacher.py:{line}",
            "launches": (train["counts"][f"fused_teacher_{which}"]
                         + baseline_train["counts"][f"fused_teacher_{which}"]),
            "specialisations": {
                "dual": train["counts"][f"fused_teacher_{which}"],
                "single": baseline_train["variants"].get(f"{which}_single", 0),
            },
            "max_abs_err": errs["dual"],
            "ms": teacher[which]["ms"], "plain_ms": teacher[which]["plain_ms"],
            "bound_ms": teacher[which]["bound_ms"], "bound_by": teacher[which]["bound_by"],
            "library_ms": None, "shape": teacher["shape"], "dtype": "float32",
            "ms_per_step": teacher[which]["ms_per_step"],
            "wrapper_ms": teacher[which]["wrapper_ms"],
            "grad_max_rel_err": teacher["grad_max_rel_err"],
            "single": {
                "ms": base["ms"], "ms_per_step": base["ms_per_step"], "plain_ms": base["plain_ms"],
                "bound_ms": base["bound_ms"], "bound_by": base["bound_by"],
                "max_abs_err": errs["single"], "shape": baseline_teacher["shape"],
                "grad_max_rel_err": baseline_teacher["grad_max_rel_err"],
            },
            **step_ms,
        })
    # the bfloat16 instantiations of the training kernels: launches are those of the
    # bfloat16 flagship's training steps; times at the same shapes as float32 (the
    # teacher kernels from seeded weights at the flagship's widths)
    step_ms_bf16 = {
        "train_step_ms": min(r["step_ms"] for r in train_bf16["rows"]),
        "plain_train_step_ms": min(r["step_ms"] for r in train_plain_bf16["rows"]),
    }
    rec = bigru_bwd_dtypes["bfloat16"]
    kernels.append({
        "name": "bigru_bwd_bf16", "route": "cuda",
        "source": "self_attention_tacotron_torch/csrc/bigru_bwd.cu",
        "replaces": "self_attention_tacotron_tpu/ops/fused_rnn.py:293",
        "instantiation": "bigru_bwd_kernel<__nv_bfloat16>",
        "launches": train_bf16["counts"]["bigru_bwd"],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        "shape": rec["shape"], "dtype": "bfloat16", "grad_max_rel_err": rec["grad_max_rel_err"],
        "train_fwd_bwd_ms": rec["train_fwd_bwd_ms"], "plain_fwd_bwd_ms": rec["plain_fwd_bwd_ms"],
        **step_ms_bf16,
    })
    t16, b16 = teacher_dtypes["bfloat16"], baseline_teacher_dtypes["bfloat16"]
    for which, line in (("fwd", 1219), ("bwd", 1310)):
        errs = {
            label: (max(t["features_max_abs_err"], t["alignments_max_abs_err"])
                    if which == "fwd" else t["grad_max_abs_err"])
            for label, t in (("dual", t16), ("single", b16))
        }
        kernels.append({
            "name": f"fused_teacher_{which}_bf16", "route": "cuda",
            "source": "self_attention_tacotron_torch/csrc/fused_teacher.cu",
            "replaces": f"self_attention_tacotron_tpu/ops/fused_teacher.py:{line}",
            "instantiation": f"teacher_{which}_kernel<true, __nv_bfloat16>",
            "launches": train_bf16["counts"][f"fused_teacher_{which}"],
            "max_abs_err": errs["dual"],
            "ms": t16[which]["ms"], "plain_ms": t16[which]["plain_ms"],
            "bound_ms": t16[which]["bound_ms"], "bound_by": t16[which]["bound_by"],
            "library_ms": None, "shape": t16["shape"], "dtype": "bfloat16",
            "ms_per_step": t16[which]["ms_per_step"], "wrapper_ms": t16[which]["wrapper_ms"],
            "grad_max_rel_err": t16["grad_max_rel_err"],
            "single": {
                "instantiation": f"teacher_{which}_kernel<false, __nv_bfloat16>",
                "ms": b16[which]["ms"], "ms_per_step": b16[which]["ms_per_step"],
                "plain_ms": b16[which]["plain_ms"], "bound_ms": b16[which]["bound_ms"],
                "bound_by": b16[which]["bound_by"], "max_abs_err": errs["single"],
                "shape": b16["shape"], "grad_max_rel_err": b16["grad_max_rel_err"],
            },
            **step_ms_bf16,
        })
    kernels += family_kernel_entries("ls", ls_decode, ls_teacher, ls_main, ls_train)
    kernels += family_kernel_entries("mgclf0", world_decode, world_teacher, world_main,
                                     world_train)
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
