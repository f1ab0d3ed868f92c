"""Multi-head self-attention blocks (encoder stream and decoder variants).

Counterpart of ``self_attention_tacotron_tpu/models/self_attention.py``:
pre-LN transformer blocks with sinusoidal positional encodings, full-sequence
for the encoder and incremental, with explicit K/V cache buffers, for the
autoregressive decoder. Softmax is always float32.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from self_attention_tacotron_torch.ops import fused_attention

_NEG_INF = -1e9
_LN_EPS = 1e-6  # the JAX package's LayerNorm epsilon; torch's default is 1e-5

KVCache = Tuple[torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=16)
def _sinusoid_table(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length, dtype=np.float64)[:, None]
    i = np.arange(dim, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, (2.0 * (i // 2)) / dim)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_table(length: int, dim: int, dtype, device) -> torch.Tensor:
    # made outside inference mode, so that the cached table can serve any later caller
    with torch.inference_mode(False):
        return torch.from_numpy(_sinusoid_table(length, dim)).to(device=device, dtype=dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (or the default one)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def positional_encoding(length: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sinusoidal positional encoding table, (length, dim); float64 table rounded to float32.

    The table is kept on its device after the first call: the decode loop asks
    for the same one at every step.
    """
    return _device_table(length, dim, dtype, torch.device(device or "cpu"))


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention, Q, K, V as one fused (D -> 3D) projection.

    With ``use_pallas`` (the flag keeps the JAX package's name), in eval mode,
    non-causal, and on a tensor that is not on the CPU, attention runs as the
    one hand-written kernel of ``ops/fused_attention.py``. In train mode and
    with a causal mask it is plain PyTorch under autograd, as the JAX package
    leaves both to XLA; train mode drops attention probabilities at
    ``drop_rate``, drawn from ``generator``, and returns the dropped ones.
    """

    def __init__(
        self,
        in_units: int,
        num_heads: int,
        num_units: int,
        drop_rate: float = 0.0,
        use_pallas: bool = False,
    ):
        super().__init__()
        if num_units % num_heads != 0:
            raise ValueError(f"num_units={num_units} is not a multiple of num_heads={num_heads}")
        self.num_heads = num_heads
        self.num_units = num_units
        self.drop_rate = drop_rate
        self.use_pallas = use_pallas
        self.qkv = nn.Linear(in_units, 3 * num_units, bias=False)
        self.out = nn.Linear(num_units, num_units)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, -1).permute(0, 2, 1, 3)

    def forward(
        self,
        x: torch.Tensor,                      # (B, T, D)
        mask: Optional[torch.Tensor] = None,  # (B, T) valid mask
        causal: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        qkv = self.qkv(x)
        if self.use_pallas and not self.training and not causal and x.device.type != "cpu":
            ctx, probs = fused_attention.mha_full(qkv, mask, self.num_heads)
            return self.out(ctx), probs
        q, k, v = (self._split(p) for p in qkv.chunk(3, dim=-1))
        d = q.shape[-1]
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(d)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], _NEG_INF)
        if causal:
            tq, tk = logits.shape[-2:]
            cmask = torch.ones(tq, tk, dtype=torch.bool, device=x.device).tril(tk - tq)
            logits = logits.masked_fill(~cmask[None, None], _NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        if self.training and self.drop_rate > 0.0:
            probs = dropout(probs, self.drop_rate, generator)
        ctx = torch.matmul(probs.to(v.dtype), v)
        b, h, tq, dd = ctx.shape
        return self.out(ctx.permute(0, 2, 1, 3).reshape(b, tq, h * dd)), probs

    def fused_step(
        self,
        x: torch.Tensor,          # (B, D) current step input (already normed)
        k_cache: torch.Tensor,    # (B, Tmax, D), updated in place
        v_cache: torch.Tensor,
        index: int,               # current step (keys 0..index valid)
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One causal step: fused QKV, cache write, attend. -> (out, k_cache, v_cache).

        The caches are written in place (the JAX package returns new arrays).
        Keys beyond ``index`` are still zero, so attending over the prefix
        0..index equals masking the rest out.
        """
        q1, k1, v1 = self.qkv(x).chunk(3, dim=-1)
        k_cache[:, index] = k1
        v_cache[:, index] = v1
        b = x.shape[0]
        n = index + 1
        q = q1.reshape(b, self.num_heads, 1, -1)
        k = self._split(k_cache[:, :n])
        v = self._split(v_cache[:, :n])
        d = q.shape[-1]
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(d)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.matmul(probs.to(v.dtype), v)
        return self.out(ctx.reshape(b, -1)), k_cache, v_cache


class SelfAttentionBlock(nn.Module):
    """Pre-LN transformer block: LN -> MHA -> res, LN -> FFN -> res."""

    def __init__(
        self,
        num_heads: int,
        num_units: int,
        ffn_units: int = 1024,
        drop_rate: float = 0.05,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.drop_rate = drop_rate
        self.ln1 = nn.LayerNorm(num_units, eps=_LN_EPS)
        self.ln2 = nn.LayerNorm(num_units, eps=_LN_EPS)
        self.mha = MultiHeadAttention(
            num_units, num_heads, num_units, drop_rate=drop_rate, use_pallas=use_pallas
        )
        self.ffn1 = nn.Linear(num_units, ffn_units)
        self.ffn2 = nn.Linear(ffn_units, num_units)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn2(F.relu(self.ffn1(x)))

    def forward(self, x, mask=None, causal=False, generator=None):
        """Train mode drops both branches at ``drop_rate`` before the residual sums."""
        drop = self.training and self.drop_rate > 0.0
        h, probs = self.mha(self.ln1(x), mask=mask, causal=causal, generator=generator)
        if drop:
            h = dropout(h, self.drop_rate, generator)
        x = x + h
        f = self._ffn(self.ln2(x))
        if drop:
            f = dropout(f, self.drop_rate, generator)
        return x + f, probs

    def step(self, x, k_cache, v_cache, index: int):
        """Incremental twin of ``forward`` in eval mode."""
        h, k_cache, v_cache = self.mha.fused_step(self.ln1(x), k_cache, v_cache, index)
        x = x + h
        return x + self._ffn(self.ln2(x)), k_cache, v_cache


class SelfAttentionTransformer(nn.Module):
    """Stack of ``num_hop`` self-attention blocks + input projection + PE."""

    def __init__(
        self,
        in_units: int,
        num_hop: int,
        num_heads: int,
        num_units: int,
        ffn_units: int = 1024,
        drop_rate: float = 0.05,
        use_positional_encoding: bool = True,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.num_hop = num_hop
        self.num_units = num_units
        self.use_positional_encoding = use_positional_encoding
        self.in_proj = nn.Linear(in_units, num_units)
        for i in range(num_hop):
            self.add_module(
                f"block_{i}",
                SelfAttentionBlock(num_heads, num_units, ffn_units, drop_rate, use_pallas),
            )

    def _blocks(self) -> List[SelfAttentionBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.num_hop)]

    def forward(self, x, mask=None, causal=False, generator=None):
        x = self.in_proj(x)
        if self.use_positional_encoding:
            x = x + positional_encoding(x.shape[1], self.num_units, x.dtype, x.device)[None]
        probs_all = []
        for block in self._blocks():
            x, probs = block(x, mask=mask, causal=causal, generator=generator)
            probs_all.append(probs)
        if mask is not None:
            x = x * mask.unsqueeze(-1).to(x.dtype)
        return x, probs_all

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        """Per-block (K, V) cache buffers for autoregressive decoding."""
        return tuple(
            (
                torch.zeros(batch, max_len, self.num_units, dtype=dtype, device=device),
                torch.zeros(batch, max_len, self.num_units, dtype=dtype, device=device),
            )
            for _ in range(self.num_hop)
        )

    def incremental_step(self, x: torch.Tensor, caches, index: int):
        """One causal decode step; matches ``forward(causal=True)`` row ``index``.

        x: (B, D) block-stack input at step ``index``. Returns (y, caches).
        """
        x = self.in_proj(x)
        if self.use_positional_encoding:
            max_len = caches[0][0].shape[1]
            x = x + positional_encoding(max_len, self.num_units, x.dtype, x.device)[index]
        new_caches = []
        for block, (k_cache, v_cache) in zip(self._blocks(), caches):
            x, k_cache, v_cache = block.step(x, k_cache, v_cache, index)
            new_caches.append((k_cache, v_cache))
        return x, tuple(new_caches)
