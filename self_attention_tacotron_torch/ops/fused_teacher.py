"""The teacher-forced decoder scan, forward and backward: CUDA kernels, plain version, wrapper.

``teacher_decode`` replaces ``teacher_decode`` of the JAX package
(``self_attention_tacotron_tpu/ops/fused_teacher.py``; its two kernels are
``_run_fwd`` and ``_run_bwd``). In teacher forcing the decoder's inputs are
known for all N steps, so the prenet runs here as two batched products over
(B * N) rows, outside any kernel, and the scanned region (attention ZoneoutLSTM,
the query projection, the additive scores, the forward-attention recursion with
or without the transition agent, contexts, two decoder ZoneoutLSTMs) runs as one
kernel launch per direction (``csrc/fused_teacher.cu``):

* forward: N steps in one launch; writes features (B, N, DU), alignments
  (B, N, S) per source side by side, and per step one carry row and one
  activation row (see ``row_layouts``) for the backward;
* backward: the adjoint chain N-1 .. 0 in one launch; reads those rows,
  regenerates the zoneout masks, recomputes only the (S, A) score tanh, writes
  ``d_keys``, ``d_spk``, one ``d_vblk`` partial per lane, one gradient row per step
  and their float32 running sum. Every weight gradient is then one batched
  product here, against inputs rebuilt from the carry rows (``grads_from_rows``),
  the memories' gradients come from the alignments and the context cotangents,
  and the prenet's gradients by autograd through the hoisted products.

A batch whose per-step rows outgrow ``ROW_MEMORY_SHARE`` of the card's total
memory (or ``slice_batch`` lanes, where the caller names a block size) runs as
sequential batch blocks outside the autograd function, as the JAX package's
``_decode_core`` runs them: the prenet and its dropout for the whole batch first,
then one launch pair per block, block ``i`` with the zoneout seed ``seed + i *
BLOCK_SEED_STRIDE``; autograd sums the weight gradients over the blocks and
concatenates the conditioning gradients. The kernels take any lane count, so a
ragged last block needs no padding (the JAX package pads it with lanes after the
real ones, which changes no real lane's masks).

What bounds both kernels on an H100 is the chain of N dependent steps, each a
handful of dependent stages: a step needs about 2 * 2.5 M * B operations on 10 MB
of float32 weights, far from what the card can do in the time the stages take.
Both kernels have the grid design of ``fused_decode`` (``csrc/grid.cuh``): one
block per SM, all resident (a cooperative launch), each holding its slice of
every matrix of its direction in shared memory for the whole launch
(``teacher_grid_plan`` mirrors how the columns are dealt out), the lanes' rows
brought in by bulk copies, grid barriers between the stages of a step (five a step
each way, six backward with location-sensitive attention), the per-lane rows and
states in a zeroed scratch buffer. A launch that cannot have every block resident
raises; nothing falls back. ``teacher_stage_times`` times the stages of one step of
the flagship's structure in float32.

Zoneout masks are not stored. In training the keep mask of (step, draw, lane,
unit) is a counter-based hash of ``seed + t`` with a murmur3 finalizer, the one
the JAX package's kernels use in interpret mode, with the global lane as the
row, so it does not depend on how lanes are grouped into blocks; the plain
version draws the same masks (``hash_keep_masks``). ``hp_like["lane0"]`` (default
0) is the global index of the launch's lane 0: a data-parallel rank passes its
first row, so that its lanes draw the masks they draw in the single-device step. In evaluation the mask is
the constant zoneout factor.

Specialised to the decoders' family, the mel head or the WORLD heads alike (the
frame's width enters only the hoisted prenet): forward attention (with or without
transition agent) on source 1 and, in the dual-source specialisation, additive
attention on source 2 over a second memory (``dual`` in ``hp_like``; the kernels
are compiled once for each); optional speaker embedding, two prenet layers, two
decoder LSTMs. With one source the query projection is the mechanism's own query
layer and there is no second key, memory, context or alignment.

Location-sensitive attention on source 1 (``src1_kind``, compiled for both
``dual`` specialisations): the scores add ``loc = taps(prev) @ w_lsW + ls_bias``
to source 1's columns before the tanh, where ``taps(prev)[s, k] = prev[s + k -
K // 2]`` (zero outside the source) of the cumulative alignments
(``ls_cumulative``; their value before the step is kept in the carry row) or the
previous ones, and ``w_lsW`` (K, A1), ``ls_bias`` (A1,) are the convolution and
the dense layer after it folded into one map (``models/attention.py::
location_fold``, outside this function, so that autograd takes the gradients
from ``w_lsW`` and ``ls_bias`` to the convolution, the layer and the bias);
alpha_1 is the softmax itself, and the alignment starts uniform. The backward
kernel recomputes the taps from the carry rows, sums ``w_lsW``'s gradient per
lane and adds the taps' adjoint to the carried alignment's cotangent; the
gradient of ``ls_bias`` is that of the query projection's first A1 columns,
summed. The kernels take up to ``MAX_TAPS`` taps, an odd number.

The io type (``hp_like["io_dtype"]``) is float32 or bfloat16; both kernels are
compiled for each. In bfloat16 they round where the JAX package's kernels cast to
their io_dtype, and everything else is float32 (``rounded``). Forward: every
product's input, the weights, biases and ``vblk`` (the scores use the rounded
one), the feeds, keys, memories and speaker embedding; the LSTM states, scores,
softmaxes, the recursion and the contexts stay float32. Backward: the cotangent
entering each product with a transposed weight, the gradient row (stored in
bfloat16; the bias gradients come from the float32 running sum); the scores'
cotangents use the unrounded float32 score vectors; each weight gradient is a
float32 product of rounded inputs and the rounded row. The prenet rounds its
products' inputs and adds its float32 bias unrounded; its output is the kernels'
bfloat16 feed. Gradients come back in the type of their primal: float32 for the
weights and the speaker embedding, bfloat16 for keys, memories and the prenet's
output. The plain version rounds at the same points in both directions
(``_Product``, ``_Scores``, ``_Context``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from self_attention_tacotron_torch.ops.fused_rnn import rounded
from self_attention_tacotron_torch.ops.grid import SLICE_BYTES, deal  # noqa: F401
from self_attention_tacotron_torch.ops.grid import round8 as _round8
from self_attention_tacotron_torch.parallel import shard
from self_attention_tacotron_torch.utils.cuda_build import load_library

# Launches of the forward and of the backward kernel made in this process
# (``teacher_stage_times``'s stamped launches included).
launch_count = 0
bwd_launch_count = 0
# Launches per kernel and specialisation: ("fwd" | "bwd", "dual" | "single", with
# ",ls" for location-sensitive attention) -> count.
variant_launches: Dict[Tuple[str, str], int] = {}
# CUDA events around the last launch of each kernel ("fwd", "bwd"); see ``last_launch_ms``.
_launch_events = {}

_EPS = 1e-6
_MASK32 = 0xFFFFFFFF

# Order of the entries in the flat weight buffer; the enum ``Entry`` of the source
# lists the same names in the same order. The last four are transposed copies.
_ENTRIES = (
    "attg_w", "attg_b", "qp_w", "vblk", "ta_w", "ta_b", "l1_w", "l1_b", "l2_w", "l2_b",
    "attg_wt", "qp_wt", "l1_wt", "l2_wt", "ls_w",
)
# Order of the sizes handed to the kernels, after (B, S, N); K, the location
# taps, is 0 without location-sensitive attention.
_SIZES = ("P2", "SPK", "AU", "A1", "A2", "DU", "E1", "E2", "K")
# Fields of the per-step rows, in the order of the source's enums.
_CARRY = ("c_att", "h_att", "c1", "h1", "c2", "h2", "ctx1", "ctx2", "alpha", "cum", "u")
_ACTS = ("z_att", "z1", "z2", "qp", "y1", "alpha2")
_STACK = ("g_z_att", "g_z1", "g_z2", "g_feed", "g_qp", "g_ctx1", "g_ctx2", "g_u_pre")
# Names of the weights of the scanned region, as ``teacher_decode`` takes them.
CORE_WEIGHTS = (
    "w_attg", "b_attg", "w_qp", "vblk", "w_ta", "b_ta", "w_l1", "b_l1", "w_l2", "b_l2",
)
# ... and, with location-sensitive attention, the folded taps and their bias.
LS_WEIGHTS = ("w_lsW", "ls_bias")
# Most location taps the kernels take (the rows of their folded matrix, zero-padded).
MAX_TAPS = 32
# Shared memory one block of an H100 may opt in to, in bytes, and at most what the
# kernels take besides the room they report: a few shared scalars, an mbarrier and the
# 128 bytes in which the backward aligns its dynamic region.
H100_BLOCK_SMEM = 232448
STATIC_SMEM = 352
# Threads of a block (csrc/grid.cuh: GRID_NT), the source positions of the attention
# stages' tiles (ATT_TILE) and the context columns one block of the forward's
# alignment stage takes (CTX_COLS), as csrc/fused_teacher.cu has them.
_NT = 512
_ATT_TILE = 512
_CTX_COLS = 128
# Room for the stamps of a step: 1 + 3 a stage.
_STAMP_SLOTS = 32

# Share of the card's total memory that one launch's per-step rows may take; a larger
# batch runs as sequential batch blocks. The total, never the free memory: the block
# size, and with it every lane's zoneout masks, must not depend on what else is
# allocated.
ROW_MEMORY_SHARE = 0.25
# Block i of a batch draws its zoneout masks from seed + i * BLOCK_SEED_STRIDE.
BLOCK_SEED_STRIDE = 1000003

_functions = {}
_IO = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def io_dtype(hp_like: Dict) -> torch.dtype:
    name = hp_like.get("io_dtype", "float32")
    _require(name in _IO, f"io_dtype must be float32 or bfloat16, got {name!r}")
    return _IO[name]


def _require(condition: bool, message: str) -> None:
    if not condition:
        raise ValueError(f"fused_teacher: {message}")


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def is_location_sensitive(hp_like: Dict) -> bool:
    return hp_like.get("src1_kind", "forward") == "location_sensitive"


def taps_supported(taps: int) -> bool:
    """Whether the kernels take a location convolution of ``taps`` taps: an odd
    number (a centred window, the SAME padding of the JAX package's kernels) of
    at most ``MAX_TAPS``."""
    return taps % 2 == 1 and 1 <= taps <= MAX_TAPS


def core_weights(hp_like: Dict) -> Tuple[str, ...]:
    """The names of the scanned region's weights for ``hp_like``."""
    return CORE_WEIGHTS + (LS_WEIGHTS if is_location_sensitive(hp_like) else ())


# --------------------------------------------------------------------------- #
# Row layouts and zoneout masks: one description for wrapper and plain version
# --------------------------------------------------------------------------- #


def row_layouts(z: Dict[str, int], src_len: int) -> Dict[str, Tuple[Dict[str, Tuple[int, int]], int]]:
    """``{"carry" | "acts" | "stack": ({field: (offset, width)}, row width)}``, in floats.

    carry: the state after a step (what the next step starts from); acts: what a
    step computed on the way and the backward does not recompute; stack: the
    cotangents a step hands to the batched weight-gradient products. With one
    source (``E2 == 0``) the second context, alignment and context cotangent
    have width 0; the cumulative alignment (after the step) has width S where
    ``z["CUM"]`` says so (location-sensitive attention over cumulative weights).
    """
    A, S = z["A1"] + z["A2"], src_len
    cum = S if z.get("CUM", 0) else 0
    widths = {
        "carry": (z["AU"], z["AU"], z["DU"], z["DU"], z["DU"], z["DU"], z["E1"], z["E2"], S, cum,
                  1),
        "acts": (4 * z["AU"], 4 * z["DU"], 4 * z["DU"], A, S, S if z["E2"] else 0),
        "stack": (4 * z["AU"], 4 * z["DU"], 4 * z["DU"], z["P2"], A, z["E1"], z["E2"], 1),
    }
    out = {}
    for kind, names in (("carry", _CARRY), ("acts", _ACTS), ("stack", _STACK)):
        fields, at = {}, 0
        for name, width in zip(names, widths[kind]):
            fields[name] = (at, width)
            at += width
        out[kind] = (fields, at)
    return out


def _col(rows: torch.Tensor, layout, name: str) -> torch.Tensor:
    at, width = layout[0][name]
    return rows[..., at : at + width]


def keep_threshold(p: float) -> int:
    """A unit keeps its previous state where the hash's 32 bits are below this."""
    return min(int(p * 2**32), 2**32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # x * c modulo 2**32 on int64 values below 2**32, without leaving int64
    low = (x & 0xFFFF) * c
    high = (((x >> 16) * c) & 0xFFFF) << 16
    return (low + high) & _MASK32


def hash_keep_masks(seed: int, num_steps: int, batch: int, width: int, draw: int,
                    threshold: int, device, lane0: int = 0) -> torch.Tensor:
    """(N, B, width) boolean keep masks of draw number ``draw`` for every step.

    bits = murmur3_finalizer((seed + t) * 0x9E3779B9 + draw * 0x85EBCA6B
    + ((lane0 + lane) * width + unit) * 0xC2B2AE35), all modulo 2**32; keep where
    bits < threshold. ``lane0``: the global index of lane 0.
    """
    t = torch.arange(num_steps, dtype=torch.int64, device=device)
    base = (_mul32((t + int(seed)) & _MASK32, 0x9E3779B9) + ((draw * 0x85EBCA6B) & _MASK32))
    first = int(lane0) * width
    idx = torch.arange(first, first + batch * width, dtype=torch.int64,
                       device=device).view(batch, width)
    x = (base[:, None, None] + _mul32(idx & _MASK32, 0xC2B2AE35)[None]) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x < threshold


def _draw_numbers(zc: float, zo: float) -> List[int]:
    """Draw number of (cell, c) and (cell, h) for the three cells: c then h per
    cell, counted from 1, a kind at factor 0 is not drawn (0 here)."""
    numbers, count = [], 0
    for _ in range(3):
        for factor in (zc, zo):
            if factor > 0.0:
                count += 1
                numbers.append(count)
            else:
                numbers.append(0)
    return numbers


def zoneout_keep_masks(hp_like: Dict, seed: int, num_steps: int, batch: int, device):
    """Per cell (attention LSTM, decoder LSTM 1 and 2) the pair (keep_c, keep_h).

    In training each is a (N, B, units) float mask from the hash; in evaluation
    the constant factor; None where the factor is 0.
    """
    zc, zo = float(hp_like["zoneout_cell"]), float(hp_like["zoneout_output"])
    units = (hp_like["att_units"], hp_like["dec_units"], hp_like["dec_units"])
    draws = _draw_numbers(zc, zo)
    masks = []
    for cell, width in enumerate(units):
        pair = []
        for kind, factor in enumerate((zc, zo)):
            if factor <= 0.0:
                pair.append(None)
            elif hp_like.get("eval_zoneout", False):
                pair.append(factor)
            else:
                pair.append(hash_keep_masks(
                    seed, num_steps, batch, width, draws[2 * cell + kind],
                    keep_threshold(factor), device, int(hp_like.get("lane0", 0)),
                ).to(torch.float32))
        masks.append(tuple(pair))
    return masks


# --------------------------------------------------------------------------- #
# The plain PyTorch version
# --------------------------------------------------------------------------- #


def _prenet(weights, feeds, drop_rate: float, prenet_masks, generator, io=torch.float32):
    """Both prenet layers over all (B, N) rows; dropout from the masks given
    ((B, N, units) boolean keep masks per layer) or drawn from ``generator``.

    bfloat16: each product's inputs rounded (by differentiable casts, whose
    gradients are rounded back as the JAX package's autodiff does), the bias
    added in float32 unrounded, ReLU and dropout in float32, the output rounded
    to bfloat16: the kernels' feed."""
    keep = 1.0 - drop_rate
    x = feeds
    for i, (w, b) in enumerate((("w_p1", "b_p1"), ("w_p2", "b_p2"))):
        x_in, w_in = x, weights[w]
        if io != torch.float32:
            x_in, w_in = x.to(io).float(), w_in.to(io).float()
        # torch.relu gives gradient 0 at exactly 0, where the zero go frame lands
        x = torch.relu(x_in @ w_in + weights[b])
        if prenet_masks is not None:
            mask = prenet_masks[i]
        elif drop_rate > 0.0:
            mask = shard.rand(x.shape, x.device, generator) < keep
        else:
            continue
        x = torch.where(mask, x / keep, torch.zeros_like(x))
    return x.to(io)


class _Product(torch.autograd.Function):
    """``x @ w (+ b)`` with the kernels' rounding points in both directions: the
    forward rounds x, w and b; the backward gives x the rounded cotangent times
    the rounded weight, w the rounded x times the rounded cotangent, b the
    unrounded cotangent's sum, all float32 (float32 io: autograd's own formulas)."""

    @staticmethod
    def forward(ctx, x, w, b, io):
        xr, wr = rounded(x, io), rounded(w, io)
        ctx.save_for_backward(xr, wr)
        ctx.io = io
        out = xr @ wr
        return out if b is None else out + rounded(b, io)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = rounded(g, ctx.io)
        g_x = gr @ wr.t() if ctx.needs_input_grad[0] else None
        g_w = xr.t() @ gr if ctx.needs_input_grad[1] else None
        g_b = g.sum(dim=0) if ctx.needs_input_grad[2] else None
        return g_x, g_w, g_b, None


class _Scores(torch.autograd.Function):
    """``tanh . vblk`` (B, S, A) x (A, n) -> (B, S, n): the forward reads the
    rounded ``vblk``, the backward the unrounded float32 one (the JAX package's
    ``vcol1`` / ``vcol2``); ``vblk``'s gradient is float32."""

    @staticmethod
    def forward(ctx, tq, v, io):
        ctx.save_for_backward(tq, v)
        return tq @ rounded(v, io)

    @staticmethod
    def backward(ctx, g_e):
        tq, v = ctx.saved_tensors
        g_v = tq.reshape(-1, tq.shape[-1]).t() @ g_e.reshape(-1, g_e.shape[-1])
        return g_e @ v.t(), g_v, None


class _Context(torch.autograd.Function):
    """``sum_s alpha[b, s] * mem[b, s, :]`` in float32; the memory's gradient is the
    rounded alignment times the rounded cotangent (the JAX package forms it after
    the backward kernel from both stacks), the alignment's the unrounded
    cotangent against the memory."""

    @staticmethod
    def forward(ctx, alpha, mem, io):
        ctx.save_for_backward(alpha, mem)
        ctx.io = io
        return (alpha[:, :, None] * mem).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        alpha, mem = ctx.saved_tensors
        g_alpha = (g[:, None, :] * mem).sum(dim=-1)
        g_mem = rounded(alpha, ctx.io)[:, :, None] * rounded(g, ctx.io)[:, None, :]
        return g_alpha, g_mem, None


def location_taps(prev: torch.Tensor, taps: int) -> torch.Tensor:
    """(B, S) -> (B, S, taps): ``out[b, s, k] = prev[b, s + k - taps // 2]``, zero
    outside [0, S) (an odd number of taps: the SAME convolution's window)."""
    half = taps // 2
    return torch.nn.functional.pad(prev, (half, taps - 1 - half)).unfold(1, taps, 1)


class _Location(torch.autograd.Function):
    """``loc = taps(prev) @ w + b`` (B, S, A1), the folded location features, with
    the kernels' rounding points: the forward rounds the taps and ``w`` and adds
    ``b`` unrounded; the backward gives ``w`` the rounded taps against the rounded
    cotangent, ``prev`` the adjoint of the taps of the rounded cotangent times the
    rounded ``w``, ``b`` the unrounded cotangent's sum, all float32."""

    @staticmethod
    def forward(ctx, prev, w, b, io):
        taps = location_taps(rounded(prev, io), w.shape[0])
        wr = rounded(w, io)
        ctx.save_for_backward(taps, wr)
        ctx.io = io
        return taps @ wr + b

    @staticmethod
    def backward(ctx, g):
        taps, wr = ctx.saved_tensors
        K, A = wr.shape
        gr = rounded(g, ctx.io)
        g_w = taps.reshape(-1, K).t() @ gr.reshape(-1, A) if ctx.needs_input_grad[1] else None
        g_prev = None
        if ctx.needs_input_grad[0]:
            g_taps = gr @ wr.t()                              # (B, S, K)
            B, S = g_taps.shape[:2]
            padded = g_taps.new_zeros(B, S + K - 1)
            for k in range(K):
                padded[:, k : k + S] += g_taps[:, :, k]
            g_prev = padded[:, K // 2 : K // 2 + S]
        g_b = g.sum(dim=(0, 1)) if ctx.needs_input_grad[2] else None
        return g_prev, g_w, g_b, None


def _zoneout_lstm(z, c, h, keep_c, keep_h, forget_bias: float):
    i, g, f, o = z.chunk(4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    out_c = new_c if keep_c is None else c * keep_c + new_c * (1.0 - keep_c)
    out_h = new_h if keep_h is None else h * keep_h + new_h * (1.0 - keep_h)
    return out_c, out_h


def _core_plain(hp_like, w, x2, keys, mem1, mem2, score_bias, spk, seed: int, taps=None):
    """The scanned region step by step, in the kernels' formulation and with
    their rounding points (``x2``, ``keys`` and the memories in the io type).

    ``taps``: a list that receives, per step, the tensors of the carry and
    activation rows and those whose gradients make the gradient row.
    Location-sensitive attention: alpha_1 is the softmax, its first value uniform,
    and the scores add ``_Location`` of the cumulative (or the previous)
    alignments to source 1's columns.
    """
    B, N, _ = x2.shape
    io = io_dtype(hp_like)
    x2, keys, mem1 = x2.float(), keys.float(), mem1.float()
    mem2 = None if mem2 is None else mem2.float()
    f32 = dict(dtype=torch.float32, device=x2.device)
    AU, DU = hp_like["att_units"], hp_like["dec_units"]
    fb = float(hp_like.get("forget_bias", 1.0))
    masks = zoneout_keep_masks(hp_like, seed, N, B, x2.device)
    step_mask = lambda m, t: m[t] if torch.is_tensor(m) else m  # noqa: E731
    dual = mem2 is not None
    ls = is_location_sensitive(hp_like)
    cumulative = ls and hp_like.get("ls_cumulative", True)

    c_att, h_att = torch.zeros(B, AU, **f32), torch.zeros(B, AU, **f32)
    c1, h1, c2, h2 = (torch.zeros(B, DU, **f32) for _ in range(4))
    ctx1 = torch.zeros(B, mem1.shape[-1], **f32)
    # one source: the second context has width 0 and so drops out of every input
    ctx2 = torch.zeros(B, mem2.shape[-1] if dual else 0, **f32)
    alpha2 = torch.zeros(B, 0, **f32)
    S, A1 = keys.shape[1], hp_like["att1_units"]
    if ls:
        alpha1 = torch.full((B, S), 1.0 / S, **f32)
    else:
        alpha1 = torch.zeros(B, S, **f32)
        alpha1[:, 0] = 1.0
    cum = torch.zeros(B, S if cumulative else 0, **f32)
    u = torch.full((B, 1), 0.5, **f32)
    features, aligns = [], []
    for t in range(N):
        x_t = x2[:, t]
        parts = [x_t] + ([spk] if spk is not None else []) + [ctx1, ctx2, h_att]
        z_att = _Product.apply(torch.cat(parts, dim=-1), w["w_attg"], w["b_attg"], io)
        c_att, h_att = _zoneout_lstm(
            z_att, c_att, h_att, step_mask(masks[0][0], t), step_mask(masks[0][1], t), fb
        )
        qp = _Product.apply(h_att, w["w_qp"], None, io)
        pre = keys + qp[:, None, :]
        if ls:
            loc = _Location.apply(cum if cumulative else alpha1, w["w_lsW"], w["ls_bias"], io)
            pre = pre + torch.nn.functional.pad(loc, (0, pre.shape[-1] - A1))
        e = _Scores.apply(torch.tanh(pre), w["vblk"], io)   # (B, S, sources)
        y1 = torch.softmax(e[..., 0] + score_bias, dim=-1)
        if ls:
            alpha1 = y1
            if cumulative:
                cum = cum + alpha1
        else:
            shifted = torch.nn.functional.pad(alpha1, (1, 0))[:, :-1]
            alpha_hat = ((1.0 - u) * alpha1 + u * shifted + _EPS) * y1
            alpha1 = alpha_hat / alpha_hat.sum(dim=-1, keepdim=True)
        ctx1 = _Context.apply(alpha1, mem1, io)
        u_pre = None
        if hp_like["use_ta"]:
            u_pre = _Product.apply(torch.cat([ctx1, h_att], dim=-1), w["w_ta"], w["b_ta"], io)
            u = torch.sigmoid(u_pre)
        if dual:
            alpha2 = torch.softmax(e[..., 1] + score_bias, dim=-1)
            ctx2 = _Context.apply(alpha2, mem2, io)
        z1 = _Product.apply(torch.cat([h_att, ctx1, ctx2, h1], dim=-1), w["w_l1"], w["b_l1"], io)
        c1, h1 = _zoneout_lstm(
            z1, c1, h1, step_mask(masks[1][0], t), step_mask(masks[1][1], t), fb
        )
        z2 = _Product.apply(torch.cat([h1, h2], dim=-1), w["w_l2"], w["b_l2"], io)
        c2, h2 = _zoneout_lstm(
            z2, c2, h2, step_mask(masks[2][0], t), step_mask(masks[2][1], t), fb
        )
        features.append(h1 + h2)
        aligns.append(torch.cat([alpha1, alpha2], dim=-1))
        if taps is not None:
            taps.append(dict(
                c_att=c_att, h_att=h_att, c1=c1, h1=h1, c2=c2, h2=h2, ctx1=ctx1, ctx2=ctx2,
                alpha=alpha1, cum=cum, u=u, z_att=z_att, z1=z1, z2=z2, qp=qp, y1=y1, alpha2=alpha2,
                x2=x_t, u_pre=u_pre,
            ))
    return torch.stack(features, dim=1), torch.stack(aligns, dim=1)


# --------------------------------------------------------------------------- #
# Operands
# --------------------------------------------------------------------------- #


def _sizes(hp_like: Dict, weights, keys, mem1, mem2, spk, x2) -> Dict[str, int]:
    """The sizes of the kernels' ``Dims``; ``E2 == A2 == 0`` means one source.
    Also holds the types: ``x2`` (the prenet's output), keys and memories in the
    io type; the speaker embedding, the score bias and the weights float32."""
    dual = bool(hp_like.get("dual", True))
    _require(hp_like.get("src1_kind", "forward") in ("forward", "location_sensitive"),
             "source 1 must use forward or location-sensitive attention")
    ls = is_location_sensitive(hp_like)
    io = io_dtype(hp_like)
    _require((mem2 is not None) == dual,
             "a second memory goes with dual=True, and only with it")
    for name, tensor in (("feeds", x2), ("keys", keys), ("mem1", mem1), ("mem2", mem2)):
        _require(tensor is None or tensor.dtype == io,
                 f"{name} must be in the io type {io}, got {None if tensor is None else tensor.dtype}")
    _require(spk is None or spk.dtype == torch.float32, "spk must be float32 (the kernels round it)")
    _require(all(name in weights for name in core_weights(hp_like)),
             f"the weights must hold {core_weights(hp_like)}")
    _require(all(weights[name].dtype == torch.float32 for name in core_weights(hp_like)),
             "the weights must be float32 (the kernels round them)")
    taps = int(hp_like.get("ls_kernel", 31)) if ls else 0
    _require(not ls or taps % 2 == 1, "the location convolution needs an odd number of taps")
    _require(not (ls and hp_like["use_ta"]), "location-sensitive attention has no transition agent")
    z = dict(
        P2=int(x2.shape[-1]), SPK=0 if spk is None else int(spk.shape[-1]),
        AU=int(hp_like["att_units"]), A1=int(hp_like["att1_units"]),
        A2=int(hp_like["att2_units"]) if dual else 0, DU=int(hp_like["dec_units"]),
        E1=int(mem1.shape[-1]), E2=int(mem2.shape[-1]) if dual else 0, K=taps,
        CUM=int(ls and hp_like.get("ls_cumulative", True)),
    )
    _require(not dual or (z["A2"] > 0 and z["E2"] > 0), "dual source needs a second mechanism")
    B, S = mem1.shape[:2]
    A, EW = z["A1"] + z["A2"], z["E1"] + z["E2"]
    expected = {
        "w_attg": (z["P2"] + z["SPK"] + EW + z["AU"], 4 * z["AU"]), "b_attg": (4 * z["AU"],),
        "w_qp": (z["AU"], A), "vblk": (A, 2 if dual else 1), "w_ta": (z["E1"] + z["AU"], 1),
        "b_ta": (1,),
        "w_l1": (z["AU"] + EW + z["DU"], 4 * z["DU"]), "b_l1": (4 * z["DU"],),
        "w_l2": (2 * z["DU"], 4 * z["DU"]), "b_l2": (4 * z["DU"],),
    }
    if ls:
        expected.update({"w_lsW": (taps, z["A1"]), "ls_bias": (z["A1"],)})
    for name, shape in expected.items():
        _require(tuple(weights[name].shape) == shape,
                 f"{name}: expected shape {shape}, got {tuple(weights[name].shape)}")
    checks = [("keys", keys, (B, S, A)), ("feeds", x2, (B, x2.shape[1], z["P2"]))]
    if dual:
        checks.append(("mem2", mem2, (B, S, z["E2"])))
    for name, tensor, shape in checks:
        _require(tuple(tensor.shape) == shape,
                 f"{name}: expected {shape}, got {tuple(tensor.shape)}")
    _require(z["E1"] % 4 == 0 and z["E2"] % 4 == 0, "memory widths must be multiples of 4")
    _require(z["AU"] + EW != z["DU"], "the first decoder LSTM would take a residual")
    return z


def _pack(z: Dict[str, int], w: Dict[str, torch.Tensor], io=torch.float32):
    """The flat weight buffer of the kernels in the io type and the offsets of
    its entries: every matrix (in, out), rows padded to 4 values, transposed
    copies next, the folded location taps last (``MAX_TAPS`` rows, zero beyond K;
    empty without them); and the float32 score vectors that the backward reads,
    (sources, A1 + A2 padded to 4)."""
    ls_w = w["w_attg"].new_zeros(0, 0)
    if z["K"]:
        ls_w = torch.nn.functional.pad(w["w_lsW"], (0, 0, 0, MAX_TAPS - z["K"]))
    tensors = {
        "attg_w": w["w_attg"], "attg_b": w["b_attg"][None], "qp_w": w["w_qp"],
        "vblk": w["vblk"].t(), "ta_w": w["w_ta"].t(), "ta_b": w["b_ta"][None],
        "l1_w": w["w_l1"], "l1_b": w["b_l1"][None], "l2_w": w["w_l2"], "l2_b": w["b_l2"][None],
        "attg_wt": w["w_attg"].t(), "qp_wt": w["w_qp"].t(),
        "l1_wt": w["w_l1"].t(), "l2_wt": w["w_l2"].t(), "ls_w": ls_w,
    }
    offsets, total = {}, 0
    for name in _ENTRIES:
        offsets[name] = total
        total += tensors[name].shape[0] * _round4(tensors[name].shape[1])
    ref = w["w_attg"]
    flat = torch.zeros(total, dtype=io, device=ref.device)
    for name in _ENTRIES:
        t = tensors[name].detach()
        rows, cols = t.shape
        flat[offsets[name] : offsets[name] + rows * _round4(cols)].view(rows, _round4(cols))[
            :, :cols] = t
    v = tensors["vblk"].detach()
    v32 = torch.zeros(v.shape[0], _round4(v.shape[1]), dtype=torch.float32, device=ref.device)
    v32[:, : v.shape[1]] = v
    return flat, v32, offsets


def _dims(z, B: int, S: int, N: int, use_ta: bool, train_masks: bool, offsets=None,
          io=torch.float32, stamp_step: int = -1):
    # the struct ``Dims`` of the source
    layouts = row_layouts(z, S)
    values = [B, S, N] + [z[k] for k in _SIZES]
    values += [int(use_ta), int(train_masks), int(z.get("CUM", 0)), int(io == torch.bfloat16),
               int(stamp_step)]
    values += [layouts[kind][1] for kind in ("carry", "acts", "stack")]
    for kind, names in (("carry", _CARRY), ("acts", _ACTS), ("stack", _STACK)):
        values += [layouts[kind][0][name][0] for name in names]
    values += [0] * len(_ENTRIES) if offsets is None else [offsets[name] for name in _ENTRIES]
    return (ctypes.c_int * len(values))(*values)


def _library():
    lib = load_library("fused_teacher")
    if "fwd" not in _functions:
        for key, name in (("fwd", "fused_teacher_fwd"), ("bwd", "fused_teacher_bwd")):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint), ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _functions[key] = fn
        lib.fused_teacher_smem_bytes.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
        lib.fused_teacher_smem_bytes.restype = ctypes.c_longlong
        for name in ("fused_teacher_smem_limit", "fused_teacher_scratch_bytes"):
            getattr(lib, name).argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def block_shared_memory(z: Dict[str, int], device, backward: bool,
                        io=torch.float32) -> Tuple[int, int]:
    """(bytes of shared memory one block of the kernel needs at the least on
    ``device``'s grid, one block per SM; bytes a block may have there), both as the
    built library reports them. Neither grows with the lanes, the source length or
    the steps."""
    lib = _library()
    dims = _dims(z, 1, 1, 1, False, False, io=io)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        limit = int(lib.fused_teacher_smem_limit(dims, int(backward)))
    if limit < 0:
        raise RuntimeError(f"fused_teacher: CUDA error {-limit} on reading the device's limits")
    return int(lib.fused_teacher_smem_bytes(dims, int(backward), sms)), limit


def _scratch(dims, backward: bool, device) -> torch.Tensor:
    """The zeroed scratch buffer of one launch: the grid barrier's counter, the
    per-lane rows and states of the stages (the decoder's initial state, or the
    adjoint's zero cotangents)."""
    size = int(_library().fused_teacher_scratch_bytes(dims, int(backward)))
    return torch.zeros(size // 4 + 4, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------- #
# The grid plan: which block holds which weights
# --------------------------------------------------------------------------- #

# The products of a step in the order they run, forward and backward (the
# backward's against the transposed weights).
PRODUCTS = {False: ("attg", "qp", "l1", "l2"), True: ("l2t", "l1t", "qpt", "attgt")}


def teacher_product_shapes(z: Dict[str, int], backward: bool) -> Dict[str, Tuple[int, int, bool]]:
    """``{product: (depth K, items, gates)}`` of one direction: items are output
    columns, or with ``gates`` units of four (an LSTM's gate product)."""
    A, EW = z["A1"] + z["A2"], z["E1"] + z["E2"]
    KA, KD1 = z["P2"] + z["SPK"] + EW + z["AU"], z["AU"] + EW + z["DU"]
    if not backward:
        return {"attg": (KA, z["AU"], True), "qp": (z["AU"], A, False),
                "l1": (KD1, z["DU"], True), "l2": (2 * z["DU"], z["DU"], True)}
    return {"l2t": (4 * z["DU"], 2 * z["DU"], False), "l1t": (4 * z["DU"], KD1, False),
            "qpt": (A, z["AU"], False), "attgt": (4 * z["AU"], KA, False)}


@dataclasses.dataclass
class TeacherGridPlan:
    """Which block of a grid owns what in one direction, and the shared memory that
    asks for.

    ``blocks[product]``: the blocks its items are dealt to (as few as give each at
    least 8 columns, or 2 units of a gate product, while a block's slice stays within
    ``SLICE_BYTES``). ``slices[b][product] = (first, count, columns)``: block ``b``
    owns items ``first .. first + count - 1`` and holds their columns (of a gate
    product ``i, g, f, o`` of each unit) in shared memory for the whole launch.
    ``weight_bytes[b]`` is its weight region; ``resident_bytes`` what the fullest
    block holds for the launch (weights, the forward's biases, the location matrix),
    ``work_bytes`` the least room of the stages (one group of four lanes' input rows
    of the widest product, or the attention stages' rows), ``smem_bytes`` their sum,
    what one block needs at the least; ``fits``: it fits ``H100_BLOCK_SMEM``.
    There is no lane cap: a product stage takes the lanes in groups of as many as
    the rest of the block holds, ``lanes_per_copy`` of the widest product on an
    H100 (0 where a block does not fit), so the lanes of one launch are those whose
    rows fit ``teacher_max_batch``.
    """

    n_blocks: int
    backward: bool
    blocks: Dict[str, int]
    slices: Tuple[Dict[str, Tuple[int, int, int]], ...]
    weight_bytes: Tuple[int, ...]
    resident_bytes: int
    work_bytes: int
    smem_bytes: int
    fits: bool
    lanes_per_copy: int

    def columns(self, product: str, sizes: Dict[str, int]) -> Tuple[int, ...]:
        """The product's output columns in the order the blocks hold them."""
        _, items, gates = teacher_product_shapes(sizes, self.backward)[product]
        cols = []
        for per_block in self.slices:
            first, count, _ = per_block[product]
            for unit in range(first, first + count):
                cols += [g * items + unit for g in range(4)] if gates else [unit]
        return tuple(cols)


def teacher_grid_plan(sizes: Dict[str, int], n_sms: int, io_dtype=torch.float32,
                      backward: bool = False) -> TeacherGridPlan:
    """The plan of one direction's kernel on a grid of ``n_sms`` blocks, as it
    computes it itself (``csrc/fused_teacher.cu``: ``plan_block``, ``smem_layout``).
    ``sizes`` are the kernels' (``_sizes``; ``K`` the location taps, 0 without)."""
    shapes = teacher_product_shapes(sizes, backward)
    io = 2 if io_dtype == torch.bfloat16 else 4
    blocks, slices, weights, biases = deal(shapes, n_sms, io, biases=not backward)
    widest = max(_round8(K) for K, _, _ in shapes.values())
    lane_floats = (8 * _ATT_TILE + 3 * _NT if backward
                   else 6 * _ATT_TILE + max(4 * _NT, _CTX_COLS))
    resident = (max(weights) + max(biases)
                + (MAX_TAPS * _round4(sizes["A1"]) * 4 if sizes["K"] else 0))
    work = max(4 * widest * io, 4 * lane_floats)
    smem = resident + work
    fits = smem + STATIC_SMEM <= H100_BLOCK_SMEM
    lanes = (H100_BLOCK_SMEM - STATIC_SMEM - resident) // (widest * io) // 4 * 4 if fits else 0
    return TeacherGridPlan(n_blocks=n_sms, backward=backward, blocks=blocks,
                           slices=tuple(slices), weight_bytes=tuple(weights),
                           resident_bytes=resident, work_bytes=work, smem_bytes=smem, fits=fits,
                           lanes_per_copy=lanes)


def _launch(which: str, pointers: Sequence[Optional[torch.Tensor]], z, dims, hp_like,
            seed: int, device) -> None:
    global launch_count, bwd_launch_count
    variant = (which, ("dual" if z["E2"] else "single") + ("_ls" if z["K"] else ""))
    zc, zo = float(hp_like["zoneout_cell"]), float(hp_like["zoneout_output"])
    scalars = (ctypes.c_float * 3)(zc, zo, float(hp_like.get("forget_bias", 1.0)))
    bits = (ctypes.c_uint * 10)(
        keep_threshold(zc), keep_threshold(zo), int(seed) & _MASK32, *_draw_numbers(zc, zo),
        int(hp_like.get("lane0", 0)) & _MASK32,
    )
    array = (ctypes.c_void_p * len(pointers))(
        *(None if x is None else x.data_ptr() for x in pointers)
    )
    fn = _functions[which]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        err = fn(array, dims, scalars, bits, torch.cuda.current_stream(device).cuda_stream)
        end.record()
    _launch_events[which] = (start, end)
    if err != 0:
        raise RuntimeError(f"fused_teacher {which} kernel launch failed: CUDA error {err}")
    if which == "fwd":
        launch_count += 1
    else:
        bwd_launch_count += 1
    variant_launches[variant] = variant_launches.get(variant, 0) + 1


def last_launch_ms(which: str) -> float:
    """Device time in ms of the last launch of the forward (``"fwd"``) or the
    backward (``"bwd"``) kernel, the kernel alone; waits for it to end."""
    start, end = _launch_events[which]
    end.synchronize()
    return start.elapsed_time(end)


# --------------------------------------------------------------------------- #
# Gradients from the backward kernel's rows
# --------------------------------------------------------------------------- #


def grads_from_rows(z, use_ta: bool, x2, spk, aligns, carries, stack, d_brow, d_keys,
                    d_vblk_lanes, d_spk, d_lsw_lanes=None) -> Dict[str, torch.Tensor]:
    """Every gradient of the scanned region from what the backward kernel wrote.

    Weight gradients are one product each over all (B * N) rows: the gradient
    row's cotangent of a product's output against that product's input, rebuilt
    from the carry rows of steps t-1 and t. Bias gradients come from the
    float32 running sum of the gradient rows, the memories' gradients from the
    alignments and the contexts' cotangents, ``vblk``'s from the per-lane partials.
    Location-sensitive attention (``z["K"] > 0``): ``w_lsW``'s from the per-lane
    partials ``d_lsw_lanes`` (B, MAX_TAPS, A1 padded to 4), ``ls_bias``'s the
    query projection's first A1 columns of the running sum.

    The io type is the gradient rows' (``stack``): in bfloat16 the carry rows are
    rounded once, and every product takes rounded inputs with a float32 result.
    Gradients come back in the type of their primal: the weights' and the
    speaker embedding's float32, keys', memories' and feeds' the io type.
    """
    B, N, _ = x2.shape
    S = d_keys.shape[1]
    io = stack.dtype
    layouts = row_layouts(z, S)
    carries = rounded(carries, io)
    prev = torch.cat([torch.zeros_like(carries[:, :1]), carries[:, :-1]], dim=1)
    cur = lambda name: _col(carries, layouts["carry"], name)   # noqa: E731
    old = lambda name: _col(prev, layouts["carry"], name)      # noqa: E731
    g = lambda name: _col(stack, layouts["stack"], name)       # noqa: E731
    bias = lambda name: _col(d_brow, layouts["stack"], name).sum(dim=0)   # noqa: E731

    def memory(alpha: torch.Tensor, g_ctx: torch.Tensor) -> torch.Tensor:
        return torch.bmm(rounded(alpha, io).transpose(1, 2), rounded(g_ctx, io)).to(io)

    def product(inputs: Sequence[torch.Tensor], cotangent: torch.Tensor) -> torch.Tensor:
        x = rounded(torch.cat(inputs, dim=-1).reshape(B * N, -1), io)
        return x.t() @ rounded(cotangent.reshape(B * N, -1), io)

    x2 = x2.float()
    speaker = [] if spk is None else [spk.float()[:, None, :].expand(B, N, spk.shape[-1])]
    grads = {
        "w_attg": product([x2, *speaker, old("ctx1"), old("ctx2"), old("h_att")], g("g_z_att")),
        "b_attg": bias("g_z_att"),
        "w_qp": product([cur("h_att")], g("g_qp")),
        "vblk": d_vblk_lanes.sum(dim=0).t(),
        "w_l1": product([cur("h_att"), cur("ctx1"), cur("ctx2"), old("h1")], g("g_z1")),
        "b_l1": bias("g_z1"),
        "w_l2": product([cur("h1"), old("h2")], g("g_z2")),
        "b_l2": bias("g_z2"),
        "keys": d_keys.to(io),
        "mem1": memory(aligns[..., :S], g("g_ctx1")),
        "mem2": memory(aligns[..., S:], g("g_ctx2")) if z["E2"] else None,
        "feeds": g("g_feed").to(io),
        "spk": None if spk is None else d_spk,
    }
    if z["K"]:
        grads["w_lsW"] = d_lsw_lanes.sum(dim=0)[: z["K"], : z["A1"]]
        grads["ls_bias"] = bias("g_qp")[: z["A1"]]
    if use_ta:
        grads["w_ta"] = product([cur("ctx1"), cur("h_att")], g("g_u_pre"))
        grads["b_ta"] = bias("g_u_pre")
    else:
        grads["w_ta"] = torch.zeros(z["E1"] + z["AU"], 1, dtype=torch.float32, device=x2.device)
        grads["b_ta"] = torch.zeros(1, dtype=torch.float32, device=x2.device)
    return grads


def _forward(hp_like, seed: int, x2, keys, mem1, mem2, score_bias, spk, core,
             stamps: Optional[Tuple[int, torch.Tensor]] = None):
    """One launch of the forward kernel: ``(features, alignments, saved)``, where
    ``saved`` is what ``_backward`` reads. ``stamps``: (step, buffer) for the stamped
    instantiation."""
    w = dict(zip(core_weights(hp_like), core))
    z = _sizes(hp_like, w, keys, mem1, mem2, spk, x2)
    _require(not z["K"] or taps_supported(z["K"]),
             f"the kernels take at most {MAX_TAPS} location taps, not {z['K']}")
    io = io_dtype(hp_like)
    device = x2.device
    B, N, _ = x2.shape
    S = keys.shape[1]
    _library()
    for backward in (False, True):
        need, have = block_shared_memory(z, device, backward, io)
        if need > have:
            raise RuntimeError(
                f"fused_teacher cannot launch: one block of the "
                f"{'backward' if backward else 'forward'} kernel needs {need} bytes of "
                f"shared memory, an SM of this device offers {have}"
            )
    operands = [x2, keys, mem1, score_bias] + [x for x in (mem2, spk) if x is not None]
    for x in operands + list(core):
        if x.device != device:
            raise TypeError("fused_teacher takes tensors on one CUDA device")
    _require(score_bias.dtype == torch.float32, "score_bias must be float32")
    f32 = dict(dtype=torch.float32, device=device)
    x2_c, keys_c, mem1_c, bias_c = (
        x.detach().contiguous() for x in (x2, keys, mem1, score_bias)
    )
    # one source: a placeholder that the kernels never read stands for the second memory
    mem2_c = torch.zeros(4, dtype=io, device=device) if mem2 is None else mem2.detach().contiguous()
    spk_c = None if spk is None else spk.detach().to(io).contiguous()
    flat, v32, offsets = _pack(z, w, io)
    # the location bias, float32; a placeholder the kernels never read without it
    ls_b = w["ls_bias"].detach().contiguous() if z["K"] else torch.zeros(4, **f32)
    train_masks = not hp_like.get("eval_zoneout", False)
    stamp_step, stamp_buffer = stamps if stamps is not None else (-1, None)
    dims = _dims(z, B, S, N, hp_like["use_ta"], train_masks, offsets, io, stamp_step)
    layouts = row_layouts(z, S)
    features = torch.empty(B, N, z["DU"], **f32)
    aligns = torch.empty(B, N, (2 if z["E2"] else 1) * S, **f32)
    carries = torch.empty(B, N, layouts["carry"][1], **f32)
    acts = torch.empty(B, N, layouts["acts"][1], **f32)
    inputs = [flat, x2_c, keys_c, mem1_c, mem2_c, bias_c, spk_c]
    _launch("fwd", inputs + [features, aligns, carries, acts] + [None] * 7 + [v32, ls_b]
            + [None] * 3 + [_scratch(dims, False, device), stamp_buffer],
            z, dims, hp_like, seed, device)
    saved = (inputs + [v32, ls_b, aligns, carries, acts], (hp_like, seed, z, dims))
    return features, aligns, saved


def _backward_rows(saved, g_features, g_aligns,
                   stamps: Optional[Tuple[int, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One launch of the backward kernel: what it wrote (``stack``, the gradient rows;
    ``d_keys``, ``d_vblk``, ``d_spk``, ``d_brow``, ``d_lsw``, the sums and per-lane
    partials; None where the specialisation has none). ``g_aligns`` None: the loss
    does not read the alignments."""
    tensors, (hp_like, seed, z, dims) = saved
    flat, x2, keys, mem1, mem2, bias, spk, v32, ls_b, aligns, carries, acts = tensors
    device = x2.device
    B, N, _ = x2.shape
    S = keys.shape[1]
    f32 = dict(dtype=torch.float32, device=device)
    values = list(dims)
    values[3 + len(_SIZES) + 4] = -1 if stamps is None else int(stamps[0])   # stamp_step
    dims = (ctypes.c_int * len(values))(*values)
    stack_width = row_layouts(z, S)["stack"][1]
    if g_features is None:
        g_features = torch.zeros(B, N, z["DU"], **f32)
    g_features = g_features.to(torch.float32).contiguous()
    g_aligns = None if g_aligns is None else g_aligns.to(torch.float32).contiguous()
    # the gradient rows in the io type; everything the kernel sums, float32 and zeroed
    stack = torch.empty(B, N, stack_width, dtype=x2.dtype, device=device)
    d_keys = torch.zeros(keys.shape, **f32)
    d_vblk = torch.zeros(B, 2 if z["E2"] else 1, keys.shape[-1], **f32)
    d_spk = torch.zeros(B, max(z["SPK"], 1), **f32)
    d_brow = torch.zeros(B, stack_width, **f32)
    # location-sensitive: the per-lane sums of w_lsW's gradient, and one step's
    # scratch of the scores' rounded cotangents (B, S, A1) and their product
    # with w_lsW (B, S, MAX_TAPS)
    d_lsw = ls_g = ls_gk = None
    if z["K"]:
        d_lsw = torch.zeros(B, MAX_TAPS, _round4(z["A1"]), **f32)
        ls_g = torch.zeros(B, S, _round4(z["A1"]), **f32)
        ls_gk = torch.empty(B, S, MAX_TAPS, **f32)
    _launch(
        "bwd",
        [flat, x2, keys, mem1, mem2, bias, spk, None, None, carries, acts,
         g_features, g_aligns, stack, d_keys, d_vblk, d_spk, d_brow, v32, ls_b,
         d_lsw, ls_g, ls_gk, _scratch(dims, True, device),
         None if stamps is None else stamps[1]],
        z, dims, hp_like, seed, device,
    )
    return dict(stack=stack, d_keys=d_keys, d_vblk=d_vblk, d_spk=d_spk[:, : z["SPK"]],
                d_brow=d_brow, d_lsw=d_lsw)


def _backward(saved, g_features, g_aligns, stamps: Optional[Tuple[int, torch.Tensor]] = None):
    """One launch of the backward kernel and the gradients formed from its rows
    (``grads_from_rows``)."""
    tensors, (hp_like, _, z, _) = saved
    x2, spk, aligns, carries = tensors[1], tensors[6], tensors[9], tensors[10]
    r = _backward_rows(saved, g_features, g_aligns, stamps)
    return grads_from_rows(z, hp_like["use_ta"], x2, spk, aligns, carries, r["stack"],
                           r["d_brow"], r["d_keys"], r["d_vblk"], r["d_spk"], r["d_lsw"])


class _TeacherCore(torch.autograd.Function):
    """The scanned region on the card: forward and backward each one kernel launch."""

    @staticmethod
    def forward(ctx, hp_like, seed, x2, keys, mem1, mem2, score_bias, spk, *core):
        features, aligns, saved = _forward(hp_like, seed, x2, keys, mem1, mem2, score_bias, spk,
                                           core)
        ctx.save_for_backward(*saved[0])
        ctx.meta = saved[1]
        # an output the loss does not read gets no cotangent (None), not a tensor of zeros
        ctx.set_materialize_grads(False)
        return features, aligns

    @staticmethod
    def backward(ctx, g_features, g_aligns):
        g = _backward((list(ctx.saved_tensors), ctx.meta), g_features, g_aligns)
        hp_like = ctx.meta[0]
        return (None, None, g["feeds"], g["keys"], g["mem1"], g["mem2"], None, g["spk"],
                *(g[name] for name in core_weights(hp_like)))


def _stage_names(ls: bool, backward: bool) -> Tuple[str, ...]:
    if not backward:
        return ("attg", "qp", "scores", "attention", "l1", "l2")
    return ("l2t", "l1t", "contexts", "scores") + (("taps",) if ls else ()) + ("qpt", "attgt")


def teacher_stage_times(*, weights, keys, mem1, mem2, score_bias, spk, feeds, seed, hp_like,
                        prenet_masks, stamp_step: int) -> Dict[str, Dict[str, float]]:
    """Microseconds of each stage of decoder step ``stamp_step`` in one forward and
    one backward launch on the card (cotangents of ones for the features, none for
    the alignments), from the ``%globaltimer`` stamps block 0 writes at the step's
    start and, for each stage, when its input rows are in shared memory (product
    stages), at its arrival at the stage's grid barrier and at its departure:
    ``{"fwd" | "bwd": {stage: µs from the previous departure to this one,
    stage + "_copy": µs until the rows are in, stage + "_wait": µs from block 0's
    arrival to its departure, "step": the whole step}}`` (the last stage of a step
    has no barrier). The stamps are compiled into the flagship's structure in float32
    alone (two sources, forward attention). Two launches, counted as any other."""
    _require(feeds.device.type == "cuda", "teacher_stage_times needs tensors on a CUDA device")
    _require(io_dtype(hp_like) == torch.float32 and bool(hp_like.get("dual", True))
             and not is_location_sensitive(hp_like),
             "the stamps are compiled for the flagship's structure in float32 alone")
    N = feeds.shape[1]
    _require(0 <= stamp_step < N, "the stamped step must be one that runs")
    device = feeds.device
    x2 = _prenet(weights, feeds, float(hp_like["prenet_drop_rate"]), prenet_masks, None)
    core = [weights[name] for name in core_weights(hp_like)]
    buffers = {k: torch.zeros(_STAMP_SLOTS, dtype=torch.int64, device=device)
               for k in ("fwd", "bwd")}
    with torch.no_grad():
        features, _, saved = _forward(hp_like, int(seed), x2, keys, mem1, mem2, score_bias, spk,
                                      core, stamps=(int(stamp_step), buffers["fwd"]))
        _backward(saved, torch.ones_like(features), None,
                  stamps=(int(stamp_step), buffers["bwd"]))
    out = {}
    for which, buffer in buffers.items():
        stamps = buffer.cpu().tolist()
        times, last = {}, stamps[0]
        for i, stage in enumerate(_stage_names(False, which == "bwd")):
            copied, arrive, leave = stamps[1 + 3 * i : 4 + 3 * i]
            times[stage] = (leave - last) / 1e3
            if copied:
                times[stage + "_copy"] = (copied - last) / 1e3
            times[stage + "_wait"] = (leave - arrive) / 1e3
            last = leave
        times["step"] = (last - stamps[0]) / 1e3
        out[which] = times
    return out


# --------------------------------------------------------------------------- #
# The wrapper
# --------------------------------------------------------------------------- #


def row_bytes_per_lane(z: Dict[str, int], src_len: int, num_steps: int,
                       io=torch.float32) -> int:
    """Bytes of device memory that one lane's per-step rows take in a forward and
    backward launch pair: features and alignments with their cotangents, the carry
    and activation rows and the two copies of the carry rows that
    ``grads_from_rows`` makes (float32), and the gradient rows (the io type)."""
    layouts = row_layouts(z, src_len)
    carry, acts, stack = (layouts[kind][1] for kind in ("carry", "acts", "stack"))
    aligns = (2 if z["E2"] else 1) * src_len
    floats = 2 * (z["DU"] + aligns) + 3 * carry + acts
    return num_steps * (4 * floats + torch.finfo(io).bits // 8 * stack)


def teacher_max_batch(z: Dict[str, int], src_len: int, num_steps: int, device,
                      io=torch.float32) -> int:
    """Most lanes one launch pair takes on ``device``: those whose per-step rows fit
    ``ROW_MEMORY_SHARE`` of the card's total memory. Raises where not even one does.
    The grid design adds no cap of its own: a product stage takes the lanes in groups
    of as many as a block's room holds (``TeacherGridPlan.lanes_per_copy``)."""
    total = torch.cuda.get_device_properties(device).total_memory
    per_lane = row_bytes_per_lane(z, src_len, num_steps, io)
    lanes = int(ROW_MEMORY_SHARE * total) // per_lane
    if lanes < 1:
        raise RuntimeError(
            f"fused_teacher: one lane's rows over {num_steps} steps take {per_lane} bytes, "
            f"more than {ROW_MEMORY_SHARE} of the device's {total}"
        )
    return lanes


def _decode(core, *, weights, keys, mem1, mem2, score_bias, spk, feeds, seed, hp_like,
            prenet_masks, generator, slice_batch, max_batch=None):
    """The prenet over the whole batch, then ``core`` once, or once per batch block
    of ``slice_batch`` lanes (default: ``max_batch(sizes, S, N)``, or the whole batch
    where that is None)."""
    _require(feeds.dim() == 3, f"feeds must be (B, N, F), got {tuple(feeds.shape)}")
    # the dropout is drawn once, for the whole batch, before any block
    x2 = _prenet(weights, feeds, float(hp_like["prenet_drop_rate"]), prenet_masks, generator,
                 io_dtype(hp_like))
    B, N = x2.shape[:2]
    if slice_batch is not None:
        limit = int(slice_batch)
        _require(limit >= 1, "slice_batch must be at least 1")
    elif max_batch is not None:
        limit = max_batch(_sizes(hp_like, weights, keys, mem1, mem2, spk, x2), keys.shape[1], N)
    else:
        limit = B
    if B <= limit:
        return core(hp_like, int(seed), x2, keys, mem1, mem2, score_bias, spk)
    cut = lambda x, start: None if x is None else x[start : start + limit]  # noqa: E731
    features, aligns = [], []
    for i, start in enumerate(range(0, B, limit)):
        f, a = core(hp_like, int(seed) + i * BLOCK_SEED_STRIDE, x2[start : start + limit],
                    *(cut(x, start) for x in (keys, mem1, mem2, score_bias, spk)))
        features.append(f)
        aligns.append(a)
    return torch.cat(features), torch.cat(aligns)


def teacher_decode_reference(*, weights, keys, mem1, mem2, score_bias, spk, feeds, seed,
                             hp_like, prenet_masks=None, generator=None, slice_batch=None):
    """Plain PyTorch version of ``teacher_decode``: the same function step by
    step, differentiable by autograd, with the same zoneout masks. It takes any
    batch in one block unless ``slice_batch`` names a block size."""
    def core(hp_like, seed, x2, keys, mem1, mem2, score_bias, spk):
        _sizes(hp_like, weights, keys, mem1, mem2, spk, x2)
        return _core_plain(hp_like, weights, x2, keys, mem1, mem2, score_bias, spk, seed)

    return _decode(core, weights=weights, keys=keys, mem1=mem1, mem2=mem2,
                   score_bias=score_bias, spk=spk, feeds=feeds, seed=seed, hp_like=hp_like,
                   prenet_masks=prenet_masks, generator=generator, slice_batch=slice_batch)


def teacher_decode(*, weights, keys, mem1, mem2, score_bias, spk, feeds, seed, hp_like,
                   prenet_masks=None, generator=None, slice_batch=None):
    """Differentiable teacher-forced decode: ``(features (B, N, DU), alignments (B, N, n * S))``
    for n sources.

    ``weights``: every matrix (in, out): the prenet's ``w_p1, b_p1, w_p2, b_p2``
    and ``CORE_WEIGHTS``. Dual source (``hp_like["dual"]``, the default):
    ``vblk`` (A1 + A2, 2) holds each mechanism's score vector in its own column
    and rows, ``w_qp`` is the fused query projection, ``keys`` (B, S, A1 + A2)
    are both mechanisms' keys side by side. One source: ``vblk`` (A1, 1),
    ``w_qp`` the mechanism's query layer, ``keys`` (B, S, A1), ``mem2`` None.
    ``score_bias`` (B, S) is 0 where valid and -1e9 where padded, ``feeds``
    (B, N, F) the teacher frames, ``seed`` the zoneout masks' seed. ``hp_like``:
    ``dual, use_ta, att_units, att1_units, att2_units, dec_units, zoneout_cell,
    zoneout_output, prenet_drop_rate, eval_zoneout, io_dtype``, optionally ``lane0``
    (the global index of lane 0 in the zoneout hash, default 0), and for
    location-sensitive attention on source 1 ``src1_kind="location_sensitive",
    ls_cumulative, ls_kernel`` with the weights ``w_lsW`` (K, A1) and ``ls_bias``
    (A1,). The weights, ``spk`` and ``score_bias`` are float32; keys and memories
    in the io type.

    Tensors on a CUDA device go to the two kernels or raise; on the CPU they go
    to ``teacher_decode_reference``. ``slice_batch``: the lanes of a batch block
    (default on the card: ``teacher_max_batch``; on the CPU the whole batch).
    """
    device = feeds.device
    if device.type == "cpu":
        return teacher_decode_reference(
            weights=weights, keys=keys, mem1=mem1, mem2=mem2, score_bias=score_bias, spk=spk,
            feeds=feeds, seed=seed, hp_like=hp_like, prenet_masks=prenet_masks,
            generator=generator, slice_batch=slice_batch,
        )
    if device.type != "cuda":
        raise RuntimeError(f"fused_teacher has no kernel for device {device}")

    def core(hp_like, seed, x2, keys, mem1, mem2, score_bias, spk):
        return _TeacherCore.apply(
            hp_like, seed, x2, keys, mem1, mem2, score_bias, spk,
            *(weights[name] for name in core_weights(hp_like)),
        )

    def max_batch(z, src_len, num_steps):
        return teacher_max_batch(z, src_len, num_steps, device, io_dtype(hp_like))

    return _decode(core, weights=weights, keys=keys, mem1=mem1, mem2=mem2,
                   score_bias=score_bias, spk=spk, feeds=feeds, seed=seed, hp_like=hp_like,
                   prenet_masks=prenet_masks, generator=generator, slice_batch=slice_batch,
                   max_batch=max_batch)
