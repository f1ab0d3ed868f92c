"""Loss functions: masked spectrogram L1/MSE, stop-token cross-entropy, regularisers.

Counterpart of ``self_attention_tacotron_tpu/models/losses.py``. Every loss masks
padding by the true target lengths and reduces in float32. In a data-parallel step
each normaliser is the global batch's (``parallel/shard.py``), so that a rank's loss
is its share of the global loss.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F

from self_attention_tacotron_torch.models.modules import sequence_mask
from self_attention_tacotron_torch.parallel import shard


def _frame_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    return sequence_mask(lengths, max_len).to(torch.float32)


def spec_loss(
    prediction: torch.Tensor,      # (B, T, D)
    target: torch.Tensor,          # (B, T, D)
    lengths: torch.Tensor,         # (B,)
    loss_type: str = "l1",
) -> torch.Tensor:
    mask = _frame_mask(lengths, target.shape[1])[..., None]
    diff = (prediction.float() - target.float()) * mask
    if loss_type == "l1":
        total = diff.abs().sum()
    elif loss_type == "mse":
        total = diff.square().sum()
    else:
        raise ValueError(f"unknown spec_loss_type {loss_type!r}")
    denom = (shard.sum_over_data(mask.sum()) * target.shape[-1]).clamp_min(1.0)
    return total / denom


def stop_token_loss(
    logits: torch.Tensor,          # (B, T)
    done: torch.Tensor,            # (B, T) 0/1 targets (1 at and after the last frame)
    lengths: torch.Tensor,         # (B,)
) -> torch.Tensor:
    """Sigmoid binary cross-entropy over valid frames."""
    mask = _frame_mask(lengths, logits.shape[1])
    logits = logits.float()
    labels = done.float()
    per = logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return (per * mask).sum() / shard.sum_over_data(mask.sum()).clamp_min(1.0)


def classification_loss(
    logits: torch.Tensor,          # (B, T, C)
    labels: torch.Tensor,          # (B, T) integer or (B, T, C) one-hot
    lengths: torch.Tensor,
) -> torch.Tensor:
    mask = _frame_mask(lengths, logits.shape[1])
    logp = F.log_softmax(logits.float(), dim=-1)
    if labels.dim() == 2:
        picked = logp.gather(-1, labels.long()[..., None])[..., 0]
    else:
        picked = (logp * labels.float()).sum(dim=-1)
    return -(picked * mask).sum() / shard.sum_over_data(mask.sum()).clamp_min(1.0)


def binary_divergence(
    prediction: torch.Tensor,
    target: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Bernoulli KL between spectrogram values normalised to [0, 1]."""
    mask = _frame_mask(lengths, target.shape[1])[..., None]
    p = prediction.float().clamp(1e-5, 1.0 - 1e-5)
    t = target.float().clamp(0.0, 1.0)
    per = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    ent = -(
        t * torch.log(t.clamp(1e-5, 1.0)) + (1.0 - t) * torch.log((1.0 - t).clamp(1e-5, 1.0))
    )
    return ((per - ent) * mask).sum() / (
        shard.sum_over_data(mask.sum()) * target.shape[-1]).clamp_min(1.0)


def l2_regularization(params: Iterable[torch.Tensor], weight: float) -> torch.Tensor:
    """``weight`` times the sum of squares of every kernel (two or more axes): not
    of biases and scales. In a data-parallel step each rank adds its share."""
    return shard.data_share(weight * sum(p.float().square().sum() for p in params if p.dim() >= 2))
