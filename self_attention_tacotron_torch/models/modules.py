"""Core neural modules: embedding, prenet, conv + batch norm, highway, cells, CBHG.

Counterpart of ``self_attention_tacotron_tpu/models/modules.py``. Activations
are (B, T, C) at every public function. Sub-module names follow the JAX
package's parameter tree (``Dense_0``, ``Conv_0``, ``BatchNorm_0``,
``gru_fwd`` ...), so that ``convert.py`` can place trained weights by name.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from self_attention_tacotron_torch.ops import fused_rnn

LSTMCarry = Tuple[torch.Tensor, torch.Tensor]  # (c, h)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, max_len) boolean mask, True where index < length."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


class Embedding(nn.Module):
    """Symbol embedding with an index offset; ids are clipped into the table."""

    def __init__(self, num_symbols: int, embedding_dim: int, index_offset: int = 0):
        super().__init__()
        self.num_symbols = num_symbols
        self.index_offset = index_offset
        self.embedding = nn.Parameter(torch.randn(num_symbols, embedding_dim) * 0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = torch.clamp(ids.long() - self.index_offset, 0, self.num_symbols - 1)
        return self.embedding[ids]


class PreNet(nn.Module):
    """FC -> ReLU -> Dropout stack. Dropout stays ON at inference.

    ``dropout_masks``: optional per-layer boolean keep-masks; a kept unit is
    scaled by 1 / keep. Without them the masks are drawn from ``generator``
    (or the default generator).
    """

    def __init__(self, in_units: int, out_units: Sequence[int], drop_rate: float = 0.5):
        super().__init__()
        self.out_units = tuple(out_units)
        self.drop_rate = drop_rate
        for i, units in enumerate(self.out_units):
            self.add_module(f"Dense_{i}", nn.Linear(in_units, units))
            in_units = units

    def forward(
        self,
        x: torch.Tensor,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        keep = 1.0 - self.drop_rate
        for i in range(len(self.out_units)):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            if dropout_masks is not None:
                mask = dropout_masks[i]
            elif self.drop_rate > 0.0:
                mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
            else:
                continue
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return x


def _same_padding(kernel_size: int) -> Tuple[int, int]:
    # SAME padding as XLA computes it: an even kernel pads one more step on the right
    return (kernel_size - 1) // 2, kernel_size // 2


class Conv1dBN(nn.Module):
    """1-D convolution (SAME) + batch norm + optional activation, on (B, T, C).

    In train mode the batch statistics are taken over every position, padded
    ones too, and the running averages are updated here, as the JAX package's
    batch norm does it: the variance is the biased one, E[x^2] - E[x]^2, both in
    the normalisation and in the running average (``nn.BatchNorm1d`` would store
    the unbiased one).
    """

    def __init__(
        self,
        in_channels: int,
        kernel_size: int,
        out_channels: int,
        activation: Optional[Callable] = F.relu,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.activation = activation
        self.Conv_0 = nn.Conv1d(in_channels, out_channels, kernel_size, padding=0, bias=False)
        # flax momentum 0.99 is torch momentum 0.01
        self.BatchNorm_0 = nn.BatchNorm1d(out_channels, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(F.pad(x.transpose(1, 2), _same_padding(self.kernel_size)))
        bn = self.BatchNorm_0
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                bn.running_mean.lerp_(mean, bn.momentum)
                bn.running_var.lerp_(var, bn.momentum)
            scale = bn.weight * torch.rsqrt(var + bn.eps)
            x = (x - mean[None, :, None]) * scale[None, :, None] + bn.bias[None, :, None]
        else:
            x = bn(x)
        x = x.transpose(1, 2)
        if self.activation is not None:
            x = self.activation(x)
        return x


class HighwayNet(nn.Module):
    """Highway layer: T * H(x) + (1 - T) * x with transform-gate bias -1."""

    def __init__(self, units: int):
        super().__init__()
        self.H = nn.Linear(units, units)
        self.T = nn.Linear(units, units)
        nn.init.constant_(self.T.bias, -1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.H(x))
        t = torch.sigmoid(self.T(x))
        return h * t + x * (1.0 - t)


class ZoneoutLSTMCell(nn.Module):
    """LSTM cell with zoneout; one fused Linear over [x, h], gates packed i, g, f, o.

    Eval: deterministic interpolation ``z * prev + (1 - z) * new``. Train: keep
    the previous state where the mask says so (masks given, or drawn from
    ``generator``).
    """

    def __init__(
        self,
        in_units: int,
        num_units: int,
        zoneout_factor_cell: float = 0.0,
        zoneout_factor_output: float = 0.0,
        forget_bias: float = 1.0,
    ):
        super().__init__()
        self.num_units = num_units
        self.zoneout_factor_cell = zoneout_factor_cell
        self.zoneout_factor_output = zoneout_factor_output
        self.forget_bias = forget_bias
        self.gates = nn.Linear(in_units + num_units, 4 * num_units)

    def _zoneout(self, new, old, factor, mask, generator):
        if factor <= 0.0:
            return new
        if self.training:
            if mask is None:
                mask = torch.rand(new.shape, device=new.device, generator=generator) < factor
            return torch.where(mask, old, new)
        return factor * old + (1.0 - factor) * new

    def forward(
        self,
        carry: LSTMCarry,
        x: torch.Tensor,
        zoneout_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[LSTMCarry, torch.Tensor]:
        c, h = carry
        i, g, f, o = self.gates(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        new_c = torch.sigmoid(f + self.forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        mc, mh = zoneout_masks if zoneout_masks is not None else (None, None)
        out_c = self._zoneout(new_c, c, self.zoneout_factor_cell, mc, generator)
        out_h = self._zoneout(new_h, h, self.zoneout_factor_output, mh, generator)
        return (out_c, out_h), out_h

    @staticmethod
    def initial_state(batch: int, num_units: int, dtype=torch.float32, device=None) -> LSTMCarry:
        z = torch.zeros(batch, num_units, dtype=dtype, device=device)
        return (z, z)


class DenseIO(nn.Module):
    """A dense layer whose kernel keeps the (in, out) layout.

    The GRU kernels read their weights as (C + H, .) with the rows ordered
    ``[x | h]``; keeping that layout in the module spares a transpose per call.
    """

    def __init__(self, in_units: int, out_units: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_units, out_units))
        self.bias = nn.Parameter(torch.zeros(out_units))
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.bias, x, self.kernel)


class GRUCell(nn.Module):
    """GRU cell whose candidate takes ``[x, r * h]`` (not cuDNN's variant)."""

    def __init__(self, in_units: int, num_units: int):
        super().__init__()
        self.num_units = num_units
        self.gates = DenseIO(in_units + num_units, 2 * num_units)
        self.candidate = DenseIO(in_units + num_units, num_units)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r, z = torch.sigmoid(self.gates(torch.cat([x, h], dim=-1))).chunk(2, dim=-1)
        n = torch.tanh(self.candidate(torch.cat([x, r * h], dim=-1)))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h

    def kernel_params(self) -> fused_rnn.GRUParams:
        return {
            "gates_kernel": self.gates.kernel, "gates_bias": self.gates.bias,
            "candidate_kernel": self.candidate.kernel, "candidate_bias": self.candidate.bias,
        }


def run_gru(
    cell: GRUCell, xs: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """Run ``cell`` over time axis 1; padded steps keep the carry and emit zero.

    ``reverse`` walks S-1 -> 0, which on a zero initial carry equals
    reversing each row's valid region, scanning, and reversing back.
    """
    S = xs.shape[1]
    h = h0
    ys = [None] * S
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        new_h, _ = cell(h, xs[:, t])
        valid = (t < lengths).unsqueeze(-1)
        h = torch.where(valid, new_h, h)
        ys[t] = torch.where(valid, h, torch.zeros_like(h))
    return torch.stack(ys, dim=1)


class BiRNN(nn.Module):
    """Bidirectional GRU over padded batches; concatenates both directions.

    With ``use_pallas`` (the flag keeps the JAX package's name) and on a
    tensor that is not on the CPU, both directions run as the hand-written
    kernels of ``ops/fused_rnn.py``: ``bigru`` in eval mode, and in train mode
    ``bigru_train``, whose backward is a kernel too. Without the flag, or on the
    CPU, the cells run step by step under autograd.
    """

    def __init__(self, cell_fwd: GRUCell, cell_bwd: GRUCell, use_pallas: bool = False):
        super().__init__()
        self.cell_fwd = cell_fwd
        self.cell_bwd = cell_bwd
        self.use_pallas = use_pallas

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if self.use_pallas and xs.device.type != "cpu":
            run = fused_rnn.bigru_train if self.training else fused_rnn.bigru
            return run(
                xs,
                lengths,
                self.cell_fwd.kernel_params(),
                self.cell_bwd.kernel_params(),
                hidden=self.cell_fwd.num_units,
            )
        h0 = torch.zeros(xs.shape[0], self.cell_fwd.num_units, dtype=xs.dtype, device=xs.device)
        ys_f = run_gru(self.cell_fwd, xs, lengths, h0)
        ys_b = run_gru(self.cell_bwd, xs, lengths, h0, reverse=True)
        return torch.cat([ys_f, ys_b], dim=-1)


class CBHG(nn.Module):
    """Conv bank (1..K) -> max-pool -> conv projections -> highway -> BiGRU."""

    # where the JAX package's parameter tree names a sub-module otherwise
    flax_aliases = {"gru_fwd": "birnn.cell_fwd", "gru_bwd": "birnn.cell_bwd"}

    def __init__(
        self,
        in_units: int,
        out_units: int,
        conv_channels: int = 128,
        max_filter_width: int = 16,
        projection1_out_channels: int = 128,
        projection2_out_channels: int = 128,
        num_highway: int = 4,
        use_pallas: bool = False,
    ):
        super().__init__()
        if projection2_out_channels != in_units:
            raise ValueError("the residual needs projection2_out_channels == input width")
        self.max_filter_width = max_filter_width
        self.num_highway = num_highway
        half = out_units // 2
        for k in range(1, max_filter_width + 1):
            self.add_module(f"conv_bank_{k}", Conv1dBN(in_units, k, conv_channels))
        self.proj1 = Conv1dBN(conv_channels * max_filter_width, 3, projection1_out_channels)
        self.proj2 = Conv1dBN(
            projection1_out_channels, 3, projection2_out_channels, activation=None
        )
        self.highway_in = (
            nn.Linear(projection2_out_channels, half)
            if projection2_out_channels != half else None
        )
        for i in range(num_highway):
            self.add_module(f"highway_{i}", HighwayNet(half))
        self.birnn = BiRNN(GRUCell(half, half), GRUCell(half, half), use_pallas=use_pallas)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        mask = sequence_mask(lengths, x.shape[1]).unsqueeze(-1).to(x.dtype)
        x = x * mask
        bank = torch.cat(
            [getattr(self, f"conv_bank_{k}")(x) for k in range(1, self.max_filter_width + 1)],
            dim=-1,
        )
        # max-pool, window 2, stride 1, SAME: one step of -inf padding on the right only
        padded = F.pad(bank.transpose(1, 2), (0, 1), value=float("-inf"))
        pooled = F.max_pool1d(padded, kernel_size=2, stride=1).transpose(1, 2)
        proj = self.proj2(self.proj1(pooled))
        highway = proj + x
        if self.highway_in is not None:
            highway = self.highway_in(highway)
        for i in range(self.num_highway):
            highway = getattr(self, f"highway_{i}")(highway)
        highway = highway * mask
        return self.birnn(highway, lengths)
