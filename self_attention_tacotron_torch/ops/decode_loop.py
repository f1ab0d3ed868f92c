"""Batched autoregressive decode: a Python loop over decoder steps.

Counterpart of ``self_attention_tacotron_tpu/ops/decode_loop.py``. Every lane
keeps running after its stop token fires; per-lane ``finished`` flags and true
lengths are tracked, frames, stop probabilities and alignments go into
preallocated buffers, and the loop ends early once every lane has fired or
``max_iters`` is reached. The early exit reads ``finished.all()`` on the host,
which costs one device synchronisation per step.

The model-specific step functions are injected, so the loop serves any
decoder family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


@dataclasses.dataclass
class DecodeResult:
    """Outputs of one batched AR synthesis call."""

    frames: Dict[str, torch.Tensor]        # head -> (B, max_iters*r, dim) float32
    stop_probs: torch.Tensor               # (B, max_iters*r) float32
    lengths: torch.Tensor                  # (B,) int32 true frame counts
    alignments: Tuple[torch.Tensor, ...]   # per source: (B, max_iters, S_i) float32
    finished: torch.Tensor                 # (B,) bool, stop token fired before the cap
    num_steps: torch.Tensor                # () int32 decoder steps actually run


def decode_incrementally(
    *,
    step_fn: Callable,        # (state, feed, t) -> (state, feature, aligns)
    post_step_fn: Callable,   # (feature, caches, t) -> (frames, stop, caches)
    init_state: Any,
    init_caches: Any,
    go_frame: torch.Tensor,   # (B, n_feed*out_dim)
    src_shapes: Tuple[int, ...],   # S_i per attention source (alignment buffers)
    head_dims: Dict[str, int],
    batch: int,
    max_iters: int,
    outputs_per_step: int,
    n_feed_frame: int,
    stop_threshold: float,
    early_exit: bool = True,
) -> DecodeResult:
    """``early_exit=False`` never reads ``finished`` on the host: the loop runs to
    ``max_iters`` without a synchronisation. Lanes, lengths and flags come out the
    same; only ``num_steps`` and the rows written after the last lane fired differ."""
    r = outputs_per_step
    device = go_frame.device
    f32 = dict(dtype=torch.float32, device=device)

    frame_bufs = {h: torch.zeros(batch, max_iters, r, d, **f32) for h, d in head_dims.items()}
    stop_buf = torch.zeros(batch, max_iters, r, **f32)
    align_bufs = tuple(torch.zeros(batch, max_iters, s, **f32) for s in src_shapes)
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    lengths = torch.zeros(batch, dtype=torch.int32, device=device)

    state, caches, feed = init_state, init_caches, go_frame
    t = 0
    while t < max_iters:
        state, feature, aligns = step_fn(state, feed, t)
        frames, stop_logits, caches = post_step_fn(feature, caches, t)

        for h in frames:
            frame_bufs[h][:, t] = frames[h].float()
        stop_probs = torch.sigmoid(stop_logits.float())           # (B, r)
        stop_buf[:, t] = stop_probs
        for buf, a in zip(align_bufs, aligns):
            buf[:, t] = a.float()

        fired_mask = stop_probs > stop_threshold                   # (B, r)
        fired = fired_mask.any(dim=-1)
        first_fire = fired_mask.int().argmax(dim=-1)               # 0 if none, guarded by fired
        newly = fired & ~finished
        lengths = torch.where(newly, (t * r + first_fire + 1).to(torch.int32), lengths)
        finished = finished | fired

        # Feed back the last n_feed_frame predicted frames (all heads
        # concatenated). A classification head (lf0) feeds back softmax
        # probabilities, the domain its one-hot teacher frames live in.
        block = torch.cat(
            [
                torch.softmax(frames[h], dim=-1) if h == "lf0" else frames[h]
                for h in head_dims
            ],
            dim=-1,
        )
        feed = block[:, r - n_feed_frame :, :].reshape(batch, -1)

        t += 1
        if early_exit and bool(finished.all()):   # host read: one synchronisation per step
            break

    # lanes that never fired decode to the step cap
    lengths = torch.where(finished, lengths, torch.full_like(lengths, t * r))
    return DecodeResult(
        frames={
            h: buf.reshape(batch, max_iters * r, head_dims[h]) for h, buf in frame_bufs.items()
        },
        stop_probs=stop_buf.reshape(batch, max_iters * r),
        lengths=lengths,
        alignments=align_bufs,
        finished=finished,
        num_steps=torch.tensor(t, dtype=torch.int32, device=device),
    )
