"""The plain reference of the benchmark's configurations, in float32.

A frozen copy of the structure of ``self_attention_tacotron_torch``'s plain
modules (the dual-source Self-Attention Tacotron with its optional postnets),
reduced to what the benchmark's configurations build, with every kernel call and
every low-precision branch taken out: each product, convolution and recurrence
is plain PyTorch in float32. It imports nothing of the program and no JAX.

Sub-modules carry the names of the JAX parameter tree (as the program's do), so
that one flat ``params/...`` / ``batch_stats/...`` dictionary of numpy arrays
loads into both sides (``weights.py``).

``set_operand_rounding(net, fn)`` rounds the operands of every product and
convolution through ``fn`` (identity by default): the control of a correctness
limit computes the reference at a lower precision through it.

The teacher-forced pass (``TacotronReference.forward``) serves both kinds of
check: training, in train mode with the program's order of random draws; and
synthesis, in eval mode, fed the frames the program served, with the dropout
masks the program used handed in.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Rounding = Callable[[torch.Tensor], torch.Tensor]
_NEG_INF = -1e9
_LN_EPS = 1e-6
_ATT_EPS = 1e-6


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def set_operand_rounding(module: nn.Module, fn: Optional[Rounding]) -> nn.Module:
    """Round the operands of every product and convolution in ``module`` through
    ``fn`` (None: no rounding); returns ``module``."""
    for m in module.modules():
        m.round_operands = fn or _identity
    return module


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def _drop(x: torch.Tensor, keep: float, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dense(nn.Linear):
    round_operands = staticmethod(_identity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.round_operands
        return F.linear(q(x.float()), q(self.weight), self.bias)


class DenseIO(nn.Module):
    """A dense layer with its kernel in (in, out) layout (the GRU cells')."""

    round_operands = staticmethod(_identity)

    def __init__(self, in_units: int, out_units: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_units, out_units))
        self.bias = nn.Parameter(torch.zeros(out_units))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.round_operands
        return torch.addmm(self.bias, q(x), q(self.kernel))


class Embedding(nn.Module):
    def __init__(self, num_symbols: int, embedding_dim: int):
        super().__init__()
        self.num_symbols = num_symbols
        self.embedding = nn.Parameter(torch.zeros(num_symbols, embedding_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[torch.clamp(ids.long(), 0, self.num_symbols - 1)]


class PreNet(nn.Module):
    """Dense -> ReLU -> dropout (on at inference too); masks given, or drawn from
    ``generator`` one call per layer."""

    def __init__(self, in_units: int, out_units: Sequence[int], drop_rate: float):
        super().__init__()
        self.out_units = tuple(out_units)
        self.drop_rate = drop_rate
        for i, units in enumerate(self.out_units):
            self.add_module(f"Dense_{i}", Dense(in_units, units))
            in_units = units

    def forward(self, x, masks=None, generator=None):
        keep = 1.0 - self.drop_rate
        for i in range(len(self.out_units)):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            if masks is not None:
                x = _drop(x, keep, masks[i])
            elif self.drop_rate > 0.0:
                mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
                x = _drop(x, keep, mask)
        return x


class Conv1dBN(nn.Module):
    """SAME convolution + batch norm (batch statistics in train mode, biased
    variance) + activation + dropout in train mode."""

    round_operands = staticmethod(_identity)

    def __init__(self, in_channels, kernel_size, out_channels, activation=F.relu,
                 drop_rate: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.activation = activation
        self.drop_rate = drop_rate
        self.Conv_0 = nn.Conv1d(in_channels, out_channels, kernel_size, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(out_channels, eps=1e-3, momentum=0.01)

    def forward(self, x, generator=None):
        q = self.round_operands
        k = self.kernel_size
        x = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
        x = F.conv1d(q(x), q(self.Conv_0.weight))
        bn = self.BatchNorm_0
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                bn.running_mean.lerp_(mean, bn.momentum)
                bn.running_var.lerp_(var, bn.momentum)
        else:
            mean, var = bn.running_mean, bn.running_var
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        x = ((x - mean[None, :, None]) * scale[None, :, None] + bn.bias[None, :, None])
        x = x.transpose(1, 2)
        if self.activation is not None:
            x = self.activation(x)
        if self.training and self.drop_rate > 0.0:
            keep = 1.0 - self.drop_rate
            x = _drop(x, keep, torch.rand(x.shape, device=x.device, generator=generator) < keep)
        return x


class HighwayNet(nn.Module):
    def __init__(self, units: int):
        super().__init__()
        self.H = Dense(units, units)
        self.T = Dense(units, units)

    def forward(self, x):
        t = torch.sigmoid(self.T(x))
        return F.relu(self.H(x)) * t + x * (1.0 - t)


class ZoneoutLSTMCell(nn.Module):
    """Gates packed i, g, f, o; zoneout as interpolation in eval mode, as the
    masks say in train mode (True: keep the previous state)."""

    def __init__(self, in_units, num_units, zoneout_cell, zoneout_output, forget_bias=1.0):
        super().__init__()
        self.num_units = num_units
        self.zoneout_factor_cell = zoneout_cell
        self.zoneout_factor_output = zoneout_output
        self.forget_bias = forget_bias
        self.gates = Dense(in_units + num_units, 4 * num_units)

    def _zoneout(self, new, old, factor, mask):
        if factor <= 0.0:
            return new
        if self.training:
            return torch.where(mask, old, new)
        return factor * old + (1.0 - factor) * new

    def forward(self, carry, x, masks=(None, None)):
        c, h = carry
        i, g, f, o = self.gates(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        new_c = torch.sigmoid(f + self.forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        out_c = self._zoneout(new_c, c, self.zoneout_factor_cell, masks[0])
        out_h = self._zoneout(new_h, h, self.zoneout_factor_output, masks[1])
        return (out_c, out_h), out_h


class GRUCell(nn.Module):
    """GRU whose candidate takes ``[x, r * h]``."""

    def __init__(self, in_units: int, num_units: int):
        super().__init__()
        self.num_units = num_units
        self.gates = DenseIO(in_units + num_units, 2 * num_units)
        self.candidate = DenseIO(in_units + num_units, num_units)

    def forward(self, h, x):
        r, z = torch.sigmoid(self.gates(torch.cat([x, h], dim=-1))).chunk(2, dim=-1)
        n = torch.tanh(self.candidate(torch.cat([x, r * h], dim=-1)))
        return (1.0 - z) * n + z * h


def run_gru(cell: GRUCell, xs, lengths, reverse: bool):
    """Padded steps keep the carry and emit zero; ``reverse`` walks S-1 -> 0."""
    steps = xs.shape[1]
    h = xs.new_zeros(xs.shape[0], cell.num_units)
    ys = [None] * steps
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        valid = (t < lengths).unsqueeze(-1)
        h = torch.where(valid, cell(h, xs[:, t]), h)
        ys[t] = torch.where(valid, h, torch.zeros_like(h))
    return torch.stack(ys, dim=1)


class BiRNN(nn.Module):
    def __init__(self, units: int):
        super().__init__()
        self.cell_fwd = GRUCell(units, units)
        self.cell_bwd = GRUCell(units, units)

    def forward(self, xs, lengths):
        return torch.cat([run_gru(self.cell_fwd, xs, lengths, False),
                          run_gru(self.cell_bwd, xs, lengths, True)], dim=-1)


class CBHG(nn.Module):
    """Conv bank 1..K -> max-pool (2, stride 1, SAME) -> two conv projections ->
    residual -> highways -> BiGRU."""

    flax_aliases = {"gru_fwd": "birnn.cell_fwd", "gru_bwd": "birnn.cell_bwd"}

    def __init__(self, in_units, out_units, conv_channels, max_filter_width,
                 projection1_out_channels, projection2_out_channels, num_highway):
        super().__init__()
        self.max_filter_width = max_filter_width
        self.num_highway = num_highway
        half = out_units // 2
        for k in range(1, max_filter_width + 1):
            self.add_module(f"conv_bank_{k}", Conv1dBN(in_units, k, conv_channels))
        self.proj1 = Conv1dBN(conv_channels * max_filter_width, 3, projection1_out_channels)
        self.proj2 = Conv1dBN(projection1_out_channels, 3, projection2_out_channels,
                              activation=None)
        self.highway_in = (Dense(projection2_out_channels, half)
                           if projection2_out_channels != half else None)
        for i in range(num_highway):
            self.add_module(f"highway_{i}", HighwayNet(half))
        self.birnn = BiRNN(half)

    def forward(self, x, lengths):
        mask = sequence_mask(lengths, x.shape[1]).unsqueeze(-1).float()
        x = x * mask
        bank = torch.cat([getattr(self, f"conv_bank_{k}")(x)
                          for k in range(1, self.max_filter_width + 1)], dim=-1)
        padded = F.pad(bank.transpose(1, 2), (0, 1), value=float("-inf"))
        pooled = F.max_pool1d(padded, kernel_size=2, stride=1).transpose(1, 2)
        highway = self.proj2(self.proj1(pooled)) + x
        if self.highway_in is not None:
            highway = self.highway_in(highway)
        for i in range(self.num_highway):
            highway = getattr(self, f"highway_{i}")(highway)
        return self.birnn(highway * mask, lengths)


def positional_encoding(length: int, dim: int, device) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float64)[:, None]
    i = np.arange(dim, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, (2.0 * (i // 2)) / dim)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle)).astype(np.float32)
    return torch.from_numpy(table).to(device)


class MultiHeadAttention(nn.Module):
    round_operands = staticmethod(_identity)

    def __init__(self, units: int, num_heads: int, drop_rate: float):
        super().__init__()
        self.num_heads = num_heads
        self.drop_rate = drop_rate
        self.qkv = Dense(units, 3 * units, bias=False)
        self.out = Dense(units, units)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, -1).permute(0, 2, 1, 3)

    def forward(self, x, mask=None, causal=False, generator=None):
        q = self.round_operands
        qh, kh, vh = (self._split(p) for p in self.qkv(x).chunk(3, dim=-1))
        logits = torch.matmul(q(qh), q(kh).transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], _NEG_INF)
        if causal:
            tq, tk = logits.shape[-2:]
            cmask = torch.ones(tq, tk, dtype=torch.bool, device=x.device).tril(tk - tq)
            logits = logits.masked_fill(~cmask[None, None], _NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        if self.training and self.drop_rate > 0.0:
            keep = 1.0 - self.drop_rate
            probs = _drop(probs, keep,
                          torch.rand(probs.shape, device=x.device, generator=generator) < keep)
        ctx = torch.matmul(q(probs), q(vh))
        b, h, t, d = ctx.shape
        return self.out(ctx.permute(0, 2, 1, 3).reshape(b, t, h * d)), probs


class SelfAttentionBlock(nn.Module):
    """Pre-LN block; train mode drops both branches before the residual sums."""

    def __init__(self, units, num_heads, ffn_units, drop_rate):
        super().__init__()
        self.drop_rate = drop_rate
        self.ln1 = nn.LayerNorm(units, eps=_LN_EPS)
        self.ln2 = nn.LayerNorm(units, eps=_LN_EPS)
        self.mha = MultiHeadAttention(units, num_heads, drop_rate)
        self.ffn1 = Dense(units, ffn_units)
        self.ffn2 = Dense(ffn_units, units)

    def forward(self, x, mask=None, causal=False, generator=None):
        drop = self.training and self.drop_rate > 0.0
        keep = 1.0 - self.drop_rate
        h, probs = self.mha(self.ln1(x), mask=mask, causal=causal, generator=generator)
        if drop:
            h = _drop(h, keep, torch.rand(h.shape, device=x.device, generator=generator) < keep)
        x = x + h
        f = self.ffn2(F.relu(self.ffn1(self.ln2(x))))
        if drop:
            f = _drop(f, keep, torch.rand(f.shape, device=x.device, generator=generator) < keep)
        return x + f, probs


class SelfAttentionTransformer(nn.Module):
    def __init__(self, in_units, num_hop, num_heads, units, ffn_units, drop_rate):
        super().__init__()
        self.num_hop = num_hop
        self.units = units
        self.in_proj = Dense(in_units, units)
        for i in range(num_hop):
            self.add_module(f"block_{i}",
                            SelfAttentionBlock(units, num_heads, ffn_units, drop_rate))

    def forward(self, x, mask=None, causal=False, generator=None):
        x = self.in_proj(x) + positional_encoding(x.shape[1], self.units, x.device)[None]
        probs_all = []
        for i in range(self.num_hop):
            x, probs = getattr(self, f"block_{i}")(x, mask, causal, generator)
            probs_all.append(probs)
        if mask is not None:
            x = x * mask.unsqueeze(-1).float()
        return x, probs_all


class AttentionMechanism(nn.Module):
    """Additive score ``v^T tanh(W_q q + keys)``; ``forward=True`` is forward
    attention (mass stays or advances one position, then reweighted by the
    additive posterior), with its optional transition agent."""

    round_operands = staticmethod(_identity)

    def __init__(self, memory_units, num_units, forward_attention, query_units,
                 transition_agent=False):
        super().__init__()
        self.num_units = num_units
        self.forward_attention = forward_attention
        self.memory_layer = Dense(memory_units, num_units, bias=False)
        self.attention_v = nn.Parameter(torch.zeros(num_units, 1))
        self.transition_factor = (Dense(memory_units + query_units, 1)
                                  if transition_agent else None)

    def initial_state(self, batch, src_len, device):
        align = torch.zeros(batch, src_len, device=device)
        if self.forward_attention:
            align[:, 0] = 1.0
        else:
            align += 1.0 / src_len
        return align, torch.full((batch, 1), 0.5, device=device)

    def forward(self, query, projected_query, keys, memory, mask, state):
        q = self.round_operands
        prev, u = state
        hidden = torch.tanh(keys + projected_query[:, None, :])
        score = torch.matmul(q(hidden), q(self.attention_v[:, 0]))
        probs = torch.softmax(score.masked_fill(~mask, _NEG_INF), dim=-1)
        if self.forward_attention:
            shifted = F.pad(prev, (1, 0))[:, :-1]
            alpha = ((1.0 - u) * prev + u * shifted + _ATT_EPS) * probs
            probs = alpha / alpha.sum(dim=-1, keepdim=True)
        context = torch.bmm(q(probs).unsqueeze(1), q(memory)).squeeze(1)
        if self.transition_factor is not None:
            u = torch.sigmoid(self.transition_factor(torch.cat([context, query], dim=-1)))
        return context, probs, (probs, u)


# --------------------------------------------------------------------------- #
# the zoneout masks of a training pass: a hash of the pass's seed, step, lane, unit
# --------------------------------------------------------------------------- #

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    low = (x & 0xFFFF) * c
    high = (((x >> 16) * c) & 0xFFFF) << 16
    return (low + high) & _MASK32


def hash_keep_masks(seed, num_steps, batch, width, draw, factor, device) -> torch.Tensor:
    """(N, B, width) masks, True (keep the previous state) with probability
    ``factor``: murmur3's finalizer of ``(seed + t) * 0x9E3779B9 + draw *
    0x85EBCA6B + (lane * width + unit) * 0xC2B2AE35`` modulo 2**32, below
    ``factor * 2**32``."""
    threshold = min(int(factor * 2**32), 2**32 - 1)
    t = torch.arange(num_steps, dtype=torch.int64, device=device)
    base = _mul32((t + int(seed)) & _MASK32, 0x9E3779B9) + ((draw * 0x85EBCA6B) & _MASK32)
    idx = torch.arange(batch * width, dtype=torch.int64, device=device).view(batch, width)
    x = (base[:, None, None] + _mul32(idx, 0xC2B2AE35)[None]) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x < threshold


def zoneout_masks(seed, steps, batch, units, zc, zo, device):
    """Per cell (the attention LSTM, then the two decoder LSTMs) the pair of
    (N, B, units) masks (cell, output); draws are numbered from 1 over the kinds
    whose factor is above 0."""
    pairs, count = [], 0
    for width in units:
        pair = []
        for factor in (zc, zo):
            if factor > 0.0:
                count += 1
                pair.append(hash_keep_masks(seed, steps, batch, width, count, factor, device))
            else:
                pair.append(None)
        pairs.append(tuple(pair))
    return pairs


class Decoder(nn.Module):
    """The dual-source self-attention decoder: prenet, attention LSTM, the two
    mechanisms on one fused query projection, residual decoder LSTMs, the causal
    self-attention over the step outputs, one output product of r frames and r
    stop logits."""

    def __init__(self, hp: Dict, memory_units: Tuple[int, int]):
        super().__init__()
        self.r = hp["outputs_per_step"]
        self.out_dim = hp["num_mels"]
        self.memory_units = memory_units
        self.att_units = hp["attention_out_units"]
        self.dec_units = hp["decoder_out_units"]
        self.zc, self.zo = hp["zoneout_factor_cell"], hp["zoneout_factor_output"]
        pre = tuple(hp["decoder_prenet_out_units"])
        self.prenet = PreNet(hp["n_feed_frame"] * self.out_dim, pre,
                             hp["decoder_prenet_drop_rate"])
        forward = {"forward": True, "additive": False}
        self.attention_0 = AttentionMechanism(
            memory_units[0], hp["attention1_out_units"], forward[hp["attention"]],
            self.att_units, hp["use_forward_attention_transition_agent"])
        self.attention_1 = AttentionMechanism(
            memory_units[1], hp["attention2_out_units"], forward[hp["attention2"]],
            self.att_units)
        self.attention_lstm = ZoneoutLSTMCell(pre[-1] + sum(memory_units), self.att_units,
                                              self.zc, self.zo)
        width = self.att_units + sum(memory_units)
        self.decoder_lstm_0 = ZoneoutLSTMCell(width, self.dec_units, self.zc, self.zo)
        self.decoder_lstm_1 = ZoneoutLSTMCell(self.dec_units, self.dec_units, self.zc, self.zo)
        sa = hp["decoder_self_attention_out_units"]
        self.self_attention = SelfAttentionTransformer(
            self.dec_units, hp["decoder_self_attention_num_hop"],
            hp["decoder_self_attention_num_heads"], sa,
            # the program's decoder keeps its own feed-forward width of 1024 (the
            # hparams' self_attention_transformer_ffn_units is the encoder's)
            1024, hp["decoder_self_attention_drop_rate"])
        self.output_projection = Dense(sa, self.r * self.out_dim + self.r)
        self.query_projection = Dense(
            self.att_units, hp["attention1_out_units"] + hp["attention2_out_units"], bias=False)

    def _mechs(self):
        return (self.attention_0, self.attention_1)

    def teacher_feeds(self, targets: torch.Tensor) -> torch.Tensor:
        """(B, T, M) frames -> (B, N, M): step n is fed the last frame of group
        n - 1, step 0 a frame of zeros."""
        b, t, m = targets.shape
        n = t // self.r
        prev = targets.reshape(b, n, self.r, m)[:, :-1, -1, :]
        return torch.cat([targets.new_zeros(b, 1, m), prev], dim=1)

    def forward(self, memories, keys, mask, targets, prenet_masks=None, generator=None):
        """Teacher-forced pass; returns (frames (B, T, M), stop logits (B, T),
        alignments per source (B, N, S)). ``prenet_masks`` ((B, N, units) per
        layer), where not given, are drawn from ``generator`` one call per layer;
        in train mode the zoneout seed is drawn after them."""
        feeds = self.teacher_feeds(targets)
        b, n = feeds.shape[:2]
        device = feeds.device
        if prenet_masks is None and self.prenet.drop_rate > 0.0:
            keep = 1.0 - self.prenet.drop_rate
            prenet_masks = [torch.rand((b, n, u), device=device, generator=generator) < keep
                            for u in self.prenet.out_units]
        zoneout = [(None, None)] * 3
        if self.training and (self.zc > 0.0 or self.zo > 0.0):
            seed = int(torch.randint(0, 2**31 - 1, (1,), device=device, generator=generator))
            zoneout = zoneout_masks(seed, n, b, (self.att_units, self.dec_units, self.dec_units),
                                    self.zc, self.zo, device)
        x_all = self.prenet(feeds, masks=prenet_masks)
        s_units = [m.num_units for m in self._mechs()]
        att_carry = (feeds.new_zeros(b, self.att_units),) * 2
        dec_carry = [(feeds.new_zeros(b, self.dec_units),) * 2 for _ in range(2)]
        att_states = [m.initial_state(b, mem.shape[1], device)
                      for m, mem in zip(self._mechs(), memories)]
        contexts = [feeds.new_zeros(b, mem.shape[2]) for mem in memories]
        features, aligns = [], ([], [])
        for t in range(n):
            step_masks = [tuple(None if m is None else m[t] for m in pair) for pair in zoneout]
            att_in = torch.cat([x_all[:, t], *contexts], dim=-1)
            att_carry, query = self.attention_lstm(att_carry, att_in, step_masks[0])
            projected = torch.split(self.query_projection(query), s_units, dim=-1)
            contexts = []
            for i, mech in enumerate(self._mechs()):
                ctx, probs, att_states[i] = mech(query, projected[i], keys[i], memories[i],
                                                 mask, att_states[i])
                contexts.append(ctx)
                aligns[i].append(probs)
            out = torch.cat([query, *contexts], dim=-1)
            for i, cell in enumerate((self.decoder_lstm_0, self.decoder_lstm_1)):
                dec_carry[i], y = cell(dec_carry[i], out, step_masks[1 + i])
                out = y + out if y.shape == out.shape else y
            features.append(out)
        features = torch.stack(features, dim=1)
        features, _ = self.self_attention(features, causal=True, generator=generator)
        block = self.output_projection(features)
        frames = block[..., : self.r * self.out_dim].reshape(b, n * self.r, self.out_dim)
        stop = block[..., self.r * self.out_dim:].reshape(b, n * self.r)
        return frames, stop, tuple(torch.stack(a, dim=1) for a in aligns)


class PostNetV2(nn.Module):
    """Convolutions (tanh) x (L - 1) and a linear one, a residual over the mel."""

    def __init__(self, out_dim, num_layers, kernel_size, channels, drop_rate):
        super().__init__()
        self.num_layers = num_layers
        in_units = out_dim
        for i in range(num_layers - 1):
            self.add_module(f"conv_{i}", Conv1dBN(in_units, kernel_size, channels,
                                                  activation=torch.tanh, drop_rate=drop_rate))
            in_units = channels
        self.add_module(f"conv_{num_layers - 1}", Conv1dBN(
            in_units, kernel_size, out_dim, activation=None, drop_rate=drop_rate))

    def forward(self, x, generator=None):
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"conv_{i}")(h, generator=generator)
        return x + h


class PostCBHG(nn.Module):
    """CBHG (256 out, bank to 8, projections 256 and num_mels) -> dense to the
    linear spectrogram's bins."""

    def __init__(self, num_mels: int, num_freq: int):
        super().__init__()
        self.cbhg = CBHG(num_mels, 256, 128, 8, 256, num_mels, 4)
        self.linear = Dense(256, num_freq)

    def forward(self, mel, lengths):
        return self.linear(self.cbhg(mel, lengths))


class TacotronReference(nn.Module):
    """Embedding -> encoder prenet -> CBHG (memory 1) -> self-attention (memory 2)
    -> teacher-forced dual-source decoder -> optional postnets."""

    flax_aliases = {"attention_0": "decoder.attention_0", "attention_1": "decoder.attention_1"}

    def __init__(self, hp: Dict):
        super().__init__()
        self.hp = hp
        self.embedding = Embedding(hp["num_symbols"], hp["embedding_dim"])
        self.encoder = nn.Module()
        pre = tuple(hp["encoder_prenet_out_units"])
        self.encoder.prenet = PreNet(hp["embedding_dim"], pre, hp["encoder_prenet_drop_rate"])
        self.encoder.cbhg = CBHG(pre[-1], hp["cbhg_out_units"], hp["conv_channels"],
                                 hp["max_filter_width"], hp["projection1_out_channels"],
                                 hp["projection2_out_channels"], hp["num_highway"])
        self.encoder.self_attention = SelfAttentionTransformer(
            hp["cbhg_out_units"], hp["self_attention_num_hop"], hp["self_attention_num_heads"],
            hp["self_attention_out_units"], hp["self_attention_transformer_ffn_units"],
            hp["self_attention_drop_rate"])
        self.decoder = Decoder(hp, (hp["cbhg_out_units"], hp["self_attention_out_units"]))
        if hp["use_postnet_v2"]:
            self.postnet_v2 = PostNetV2(hp["num_mels"], hp["postnet_v2_num_layers"],
                                        hp["postnet_v2_kernel_size"],
                                        hp["postnet_v2_out_channels"], hp["postnet_v2_drop_rate"])
        if hp["use_linear_spectrogram_postnet"]:
            self.post_cbhg = PostCBHG(hp["num_mels"], hp["num_freq"])
        set_operand_rounding(self, None)

    def encode(self, source, source_lengths, prenet_masks=None, generator=None):
        """(memory 1, memory 2, keys, mask, encoder self-attention probabilities)."""
        x = self.encoder.prenet(self.embedding(source), masks=prenet_masks, generator=generator)
        memory1 = self.encoder.cbhg(x, source_lengths)
        mask = sequence_mask(source_lengths, source.shape[1])
        memory2, sa_probs = self.encoder.self_attention(memory1, mask=mask, generator=generator)
        memories = (memory1, memory2)
        keys = tuple(m.memory_layer(mem) for m, mem in zip(self.decoder._mechs(), memories))
        return memories, keys, mask, sa_probs

    def postnets(self, mel, lengths, generator=None):
        """(PostNetV2's mel or None, PostCBHG's linear spectrogram or None)."""
        post = lin = None
        if self.hp["use_postnet_v2"]:
            post = self.postnet_v2(mel, generator=generator)
        if self.hp["use_linear_spectrogram_postnet"]:
            lin = self.post_cbhg(post if post is not None else mel, lengths)
        return post, lin

    def forward(self, source, source_lengths, targets, target_lengths, encoder_masks=None,
                decoder_masks=None, generator=None):
        """Teacher-forced pass: a dict of ``mel`` (B, T, M), ``stop_logits`` (B, T),
        ``alignments`` (per source (B, N, S)), ``encoder_sa`` (per block (B, H, S, S)),
        and ``postnet_mel`` / ``linear`` where configured (postnets over the decoded
        mel of every frame)."""
        memories, keys, mask, sa_probs = self.encode(source, source_lengths, encoder_masks,
                                                     generator)
        mel, stop, aligns = self.decoder(memories, keys, mask, targets, decoder_masks, generator)
        post, lin = self.postnets(mel, target_lengths, generator)
        return dict(mel=mel, stop_logits=stop, alignments=aligns, encoder_sa=sa_probs,
                    postnet_mel=post, linear=lin)


def _frame_mask(lengths, max_len):
    return sequence_mask(lengths, max_len).float()


def losses(out: Dict, batch: Dict, hp: Dict) -> Dict[str, torch.Tensor]:
    """The loss parts of a training step and their sum under ``loss``: L1 of the
    mel (and of the postnets' outputs where configured) over valid frames, and
    the stop token's sigmoid cross-entropy."""
    lengths = batch["target_lengths"]

    def spec(pred, target):
        mask = _frame_mask(lengths, target.shape[1])[..., None]
        diff = (pred - target) * mask
        if hp["spec_loss_type"] == "l1":
            total = diff.abs().sum()
        else:
            total = diff.square().sum()
        return total / (mask.sum() * target.shape[-1]).clamp_min(1.0)

    parts = {"mel_loss": spec(out["mel"], batch["mel"])}
    if out["postnet_mel"] is not None:
        parts["postnet_loss"] = spec(out["postnet_mel"], batch["mel"])
    if out["linear"] is not None and "spec" in batch:
        parts["linear_loss"] = spec(out["linear"], batch["spec"])
    logits, labels = out["stop_logits"], batch["done"].float()
    mask = _frame_mask(lengths, logits.shape[1])
    per = logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    parts["done_loss"] = (per * mask).sum() / mask.sum().clamp_min(1.0)
    parts["loss"] = sum(parts.values())
    return parts


def learning_rate(hp: Dict, step: int) -> float:
    """Exponential half-life decay over 50,000 steps, floored at 1 %."""
    init = float(hp["initial_learning_rate"])
    if not hp["decay_learning_rate"]:
        return init
    lr = init * 0.5 ** (float(step) * max(hp["learning_rate_step_factor"], 1) / 50_000.0)
    return max(lr, init / 100.0)


def make_adam(hp: Dict, params) -> torch.optim.Adam:
    return torch.optim.Adam(list(params), lr=float(hp["initial_learning_rate"]),
                            betas=(hp["adam_beta1"], hp["adam_beta2"]), eps=hp["adam_eps"])


def train_step(net: TacotronReference, adam, hp: Dict, step: int, batch: Dict,
               generator) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """One update: the loss parts (floats) and every leaf's gradient as Adam gets
    it (clipped by the global norm where configured), by parameter name."""
    net.train()
    adam.zero_grad(set_to_none=True)
    out = net(batch["source"], batch["source_lengths"], batch["mel"], batch["target_lengths"],
              generator=generator)
    parts = losses(out, batch, hp)
    parts["loss"].backward()
    named = [(k, p) for k, p in net.named_parameters() if p.grad is not None]
    norm = torch.sqrt(sum(p.grad.square().sum() for _, p in named))
    if hp["use_gradient_clipping"] and hp["gradient_clip_norm"] > 0:
        scale = hp["gradient_clip_norm"] / torch.clamp(norm, min=hp["gradient_clip_norm"])
        for _, p in named:
            p.grad.mul_(scale)
    grads = {k: p.grad.detach().clone() for k, p in named}
    for group in adam.param_groups:
        group["lr"] = learning_rate(hp, step)
    adam.step()
    floats = {k: float(v) for k, v in parts.items()}
    floats["grad_norm"] = float(norm)
    return floats, grads

