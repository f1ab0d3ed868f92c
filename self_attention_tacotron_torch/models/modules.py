"""Core neural modules: embedding, prenet, conv + batch norm, highway, cells, CBHG.

Counterpart of ``self_attention_tacotron_tpu/models/modules.py``. Activations
are (B, T, C) at every public function. Sub-module names follow the JAX
package's parameter tree (``Dense_0``, ``Conv_0``, ``BatchNorm_0``,
``gru_fwd`` ...), so that ``convert.py`` can place trained weights by name.

Every module follows flax's ``dtype`` semantics with its ``compute_dtype``
(float32 unless ``set_compute_dtype`` says otherwise): parameters stay float32;
a dense layer or convolution casts its input, kernel and bias to the compute
dtype and returns that dtype; a normalisation takes its statistics and
normalises in float32 and returns the compute dtype; every other operation runs
in the dtype of what it is given.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from self_attention_tacotron_torch.ops import fused_rnn
from self_attention_tacotron_torch.parallel import shard

LSTMCarry = Tuple[torch.Tensor, torch.Tensor]  # (c, h)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Give ``module`` and every module inside it the compute dtype ``dtype``
    (flax's ``dtype`` field of each module); returns ``module``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    for m in module.modules():
        m.compute_dtype = dtype
    return module


class Dense(nn.Linear):
    """``nn.Linear`` as flax's ``nn.Dense`` computes it in ``compute_dtype``: the
    input, kernel and bias cast to it, the product in it, then the bias added in
    it. In float32 it is ``nn.Linear`` itself."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype == torch.float32:
            return F.linear(x.to(dtype), self.weight, self.bias)
        y = torch.matmul(x.to(dtype), self.weight.to(dtype).t())
        return y if self.bias is None else y + self.bias.to(dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` as flax's ``nn.LayerNorm`` computes it in ``compute_dtype``
    bfloat16: mean and E[x^2] - mean^2 of the input in float32, the float32 scale
    and bias applied in float32, the result cast to bfloat16. In float32 it is
    ``nn.LayerNorm`` itself."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.compute_dtype)


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX applies it to an array of ``dtype``: rounded to that
    dtype first (torch would apply it unrounded to a bfloat16 tensor)."""
    return value if dtype == torch.float32 else float(torch.tensor(value, dtype=dtype))


class _Logistic(torch.autograd.Function):
    """``lax.logistic`` in a low-precision dtype: the forward ``1 / (1 + exp(-x))``,
    each operation in ``x``'s dtype; the backward JAX's rule for the primitive,
    ``g * (s * (1 - s))``, each operation in that dtype. Autograd through the
    composed forward would give ``0 * inf``, not a number, where ``exp(-x)``
    overflows (x below about -88.7)."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it: ``1 / (1 + exp(-x))``, each operation
    in ``x``'s dtype, so that in bfloat16 each is rounded (``torch.sigmoid`` rounds
    once, and differs in the last bit on a third of the values), differentiated as
    JAX differentiates it (``_Logistic``); ``torch.sigmoid`` in float32."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return _Logistic.apply(x)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, max_len) boolean mask, True where index < length."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


class Embedding(nn.Module):
    """Symbol embedding with an index offset; ids are clipped into the table."""

    compute_dtype = torch.float32

    def __init__(self, num_symbols: int, embedding_dim: int, index_offset: int = 0):
        super().__init__()
        self.num_symbols = num_symbols
        self.index_offset = index_offset
        self.embedding = nn.Parameter(torch.randn(num_symbols, embedding_dim) * 0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = torch.clamp(ids.long() - self.index_offset, 0, self.num_symbols - 1)
        return self.embedding[ids].to(self.compute_dtype)


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
            self.add_module(f"Dense_{i}", Dense(in_units, units))
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
                mask = shard.rand(x.shape, x.device, generator) < keep
            else:
                continue
            x = torch.where(mask, x / in_dtype(keep, x.dtype), torch.zeros_like(x))
        return x


def _same_padding(kernel_size: int) -> Tuple[int, int]:
    # SAME padding as XLA computes it: an even kernel pads one more step on the right
    return (kernel_size - 1) // 2, kernel_size // 2


class Conv1dBN(nn.Module):
    """1-D convolution (SAME) + batch norm + optional activation + optional
    dropout, on (B, T, C).

    In train mode the batch statistics are taken over every position, padded
    ones too, and the running averages are updated here, as the JAX package's
    batch norm does it: the variance is the biased one, E[x^2] - E[x]^2, both in
    the normalisation and in the running average (``nn.BatchNorm1d`` would store
    the unbiased one). In bfloat16 the convolution runs in bfloat16 and the batch
    norm in float32 (statistics and normalisation), its result cast back. In a
    data-parallel step the statistics are the global batch's, from sums all-reduced
    over the data axis (``parallel.shard.batch_moments``), so that the running
    averages stay equal on every rank.
    ``drop_rate`` drops after the activation in train mode only, its keep-mask
    drawn from ``generator``.
    """

    compute_dtype = torch.float32

    def __init__(
        self,
        in_channels: int,
        kernel_size: int,
        out_channels: int,
        activation: Optional[Callable] = F.relu,
        drop_rate: float = 0.0,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.activation = activation
        self.drop_rate = drop_rate
        self.Conv_0 = nn.Conv1d(in_channels, out_channels, kernel_size, padding=0, bias=False)
        # flax momentum 0.99 is torch momentum 0.01
        self.BatchNorm_0 = nn.BatchNorm1d(out_channels, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        x = F.pad(x.to(dtype).transpose(1, 2), _same_padding(self.kernel_size))
        x = F.conv1d(x, self.Conv_0.weight.to(dtype))
        bn = self.BatchNorm_0
        if self.training:
            x32 = x.float()
            if shard.current() is None:
                mean = x32.mean(dim=(0, 2))
                var = ((x32 * x32).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
            else:   # a data-parallel step: the global batch's statistics
                mean, var = shard.batch_moments(x32, (0, 2))
            with torch.no_grad():
                bn.running_mean.lerp_(mean, bn.momentum)
                bn.running_var.lerp_(var, bn.momentum)
            scale = bn.weight * torch.rsqrt(var + bn.eps)
            x = (x32 - mean[None, :, None]) * scale[None, :, None] + bn.bias[None, :, None]
        elif dtype == torch.float32:
            x = bn(x)
        else:
            scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            x = (x.float() - bn.running_mean[None, :, None]) * scale[None, :, None]
            x = x + bn.bias[None, :, None]
        x = x.to(dtype).transpose(1, 2)
        if self.activation is not None:
            x = self.activation(x)
        if self.training and self.drop_rate > 0.0:
            keep = 1.0 - self.drop_rate
            mask = shard.rand(x.shape, x.device, generator) < keep
            x = torch.where(mask, x / in_dtype(keep, x.dtype), torch.zeros_like(x))
        return x


class HighwayNet(nn.Module):
    """Highway layer: T * H(x) + (1 - T) * x with transform-gate bias -1."""

    def __init__(self, units: int):
        super().__init__()
        self.H = Dense(units, units)
        self.T = Dense(units, units)
        nn.init.constant_(self.T.bias, -1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.H(x))
        t = sigmoid(self.T(x))
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
        self.gates = Dense(in_units + num_units, 4 * num_units)

    def _zoneout(self, new, old, factor, mask, generator):
        if factor <= 0.0:
            return new
        if self.training:
            if mask is None:
                mask = shard.rand(new.shape, new.device, generator) < factor
            return torch.where(mask, old, new)
        return in_dtype(factor, new.dtype) * old + in_dtype(1.0 - factor, new.dtype) * new

    def forward(
        self,
        carry: LSTMCarry,
        x: torch.Tensor,
        zoneout_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[LSTMCarry, torch.Tensor]:
        c, h = carry
        i, g, f, o = self.gates(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        new_c = sigmoid(f + in_dtype(self.forget_bias, f.dtype)) * c + sigmoid(i) * torch.tanh(g)
        new_h = sigmoid(o) * torch.tanh(new_c)
        mc, mh = zoneout_masks if zoneout_masks is not None else (None, None)
        out_c = self._zoneout(new_c, c, self.zoneout_factor_cell, mc, generator)
        out_h = self._zoneout(new_h, h, self.zoneout_factor_output, mh, generator)
        return (out_c, out_h), out_h

    @staticmethod
    def initial_state(batch: int, num_units: int, dtype=torch.float32, device=None) -> LSTMCarry:
        z = torch.zeros(batch, num_units, dtype=dtype, device=device)
        return (z, z)

    def kernel_params(self) -> fused_rnn.LSTMParams:
        """The gate product as the LSTM kernel reads it: (in + H, 4H), rows ``[x | h]``."""
        return {"kernel": self.gates.weight.t(), "bias": self.gates.bias}


class DenseIO(nn.Module):
    """A dense layer whose kernel keeps the (in, out) layout; ``Dense`` otherwise.

    The GRU kernels read their weights as (C + H, .) with the rows ordered
    ``[x | h]``; keeping that layout in the module spares a transpose per call.
    """

    compute_dtype = torch.float32

    def __init__(self, in_units: int, out_units: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_units, out_units))
        self.bias = nn.Parameter(torch.zeros(out_units))
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype == torch.float32:
            return torch.addmm(self.bias, x.to(dtype), self.kernel)
        return torch.matmul(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)


class GRUCell(nn.Module):
    """GRU cell whose candidate takes ``[x, r * h]`` (not cuDNN's variant)."""

    def __init__(self, in_units: int, num_units: int):
        super().__init__()
        self.num_units = num_units
        self.gates = DenseIO(in_units + num_units, 2 * num_units)
        self.candidate = DenseIO(in_units + num_units, num_units)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r, z = sigmoid(self.gates(torch.cat([x, h], dim=-1))).chunk(2, dim=-1)
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


def run_lstm(
    cell: ZoneoutLSTMCell, xs: torch.Tensor, lengths: torch.Tensor, reverse: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Run ``cell`` over time axis 1 from a zero carry; padded steps keep both
    carries and emit zero. ``reverse`` as in ``run_gru``. In train mode the
    zoneout masks are drawn from ``generator``, one draw per step and kind."""
    S = xs.shape[1]
    carry = ZoneoutLSTMCell.initial_state(xs.shape[0], cell.num_units, xs.dtype, xs.device)
    ys = [None] * S
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        (c, h), _ = cell(carry, xs[:, t], generator=generator)
        valid = (t < lengths).unsqueeze(-1)
        carry = (torch.where(valid, c, carry[0]), torch.where(valid, h, carry[1]))
        ys[t] = torch.where(valid, carry[1], torch.zeros_like(h))
    return torch.stack(ys, dim=1)


class BiRNN(nn.Module):
    """Bidirectional GRU or ZoneoutLSTM over padded batches; concatenates both directions.

    With ``use_pallas`` (the flag keeps the JAX package's name) and on a
    tensor that is not on the CPU, both directions run as the hand-written
    kernels of ``ops/fused_rnn.py``: GRU cells as ``bigru`` in eval mode and in
    train mode as ``bigru_train``, whose backward is a kernel too; ZoneoutLSTM
    cells as ``bilstm`` in eval mode (the JAX package has no training kernel for
    them). Otherwise, and on the CPU, the cells run step by step under autograd.
    """

    def __init__(self, cell_fwd: nn.Module, cell_bwd: nn.Module, use_pallas: bool = False):
        super().__init__()
        self.cell_fwd = cell_fwd
        self.cell_bwd = cell_bwd
        self.use_pallas = use_pallas

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lstm = isinstance(self.cell_fwd, ZoneoutLSTMCell)
        kernel = self.use_pallas and xs.device.type != "cpu"
        if kernel and lstm and not self.training:
            cell = self.cell_fwd
            return fused_rnn.bilstm(
                xs, lengths, cell.kernel_params(), self.cell_bwd.kernel_params(),
                hidden=cell.num_units, zoneout_cell=cell.zoneout_factor_cell,
                zoneout_output=cell.zoneout_factor_output, forget_bias=cell.forget_bias,
            )
        if kernel and not lstm:
            run = fused_rnn.bigru_train if self.training else fused_rnn.bigru
            return run(
                xs,
                lengths,
                self.cell_fwd.kernel_params(),
                self.cell_bwd.kernel_params(),
                hidden=self.cell_fwd.num_units,
            )
        if lstm:
            ys_f = run_lstm(self.cell_fwd, xs, lengths, generator=generator)
            ys_b = run_lstm(self.cell_bwd, xs, lengths, reverse=True, generator=generator)
            return torch.cat([ys_f, ys_b], dim=-1)
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
            Dense(projection2_out_channels, half)
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
