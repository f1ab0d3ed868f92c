"""Postnets: the conv-residual mel refinement (v2) and the CBHG to a linear spectrogram.

Counterpart of ``self_attention_tacotron_tpu/models/postnet.py``. Sub-module
names follow the JAX package's parameter tree (``conv_0`` ... of ``PostNetV2``;
``cbhg`` and ``linear`` of ``PostCBHG``), so that ``convert.py`` places their
weights by name.

``PostNetV2`` does not mask its input: a frame past a lane's length reaches the
frames before it through the convolutions, as in the JAX package. ``PostCBHG``
masks by the lengths it is given (its ``CBHG`` does). Its BiGRU runs through the
``bigru`` kernels where ``use_pallas`` is set and the tensor is on the card
(``BiRNN``), and step by step otherwise; the GRU cell is deterministic, so both
compute the same function, which the JAX package computes as a scan.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from self_attention_tacotron_torch.models.modules import CBHG, Conv1dBN, Dense


class PostNetV2(nn.Module):
    """Conv(tanh) x (L - 1) -> Conv(linear), a residual over the decoded mel.

    ``cond_units`` is the width of an optional per-utterance conditioning (the
    speaker embedding under ``hparams.channel_id_to_postnet``), broadcast over
    time and concatenated to the input of the convolutions.
    """

    def __init__(
        self,
        out_dim: int,
        num_layers: int = 5,
        kernel_size: int = 5,
        out_channels: int = 512,
        drop_rate: float = 0.5,
        cond_units: int = 0,
    ):
        super().__init__()
        self.num_layers = num_layers
        in_units = out_dim + cond_units
        for i in range(num_layers - 1):
            self.add_module(f"conv_{i}", Conv1dBN(
                in_units, kernel_size, out_channels, activation=torch.tanh, drop_rate=drop_rate))
            in_units = out_channels
        self.add_module(f"conv_{num_layers - 1}", Conv1dBN(
            in_units, kernel_size, out_dim, activation=None, drop_rate=drop_rate))

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        if cond is not None:
            b, t, _ = x.shape
            h = torch.cat([h, cond[:, None, :].expand(b, t, cond.shape[-1])], dim=-1)
        for i in range(self.num_layers):
            h = getattr(self, f"conv_{i}")(h, generator=generator)
        return x + h


class PostCBHG(nn.Module):
    """CBHG over the predicted mel -> linear-spectrogram frames (the Griffin-Lim path).

    The CBHG's widths are the JAX module's defaults (256 out, so a BiGRU of 128
    units a direction; a conv bank up to width 8; projections 256 and ``in_units``);
    ``hparams.cbhg_out_units`` is the encoder's, not this CBHG's.
    """

    def __init__(
        self,
        in_units: int,
        out_dim: int,
        cbhg_out_units: int = 256,
        conv_channels: int = 128,
        max_filter_width: int = 8,
        projection1_out_channels: int = 256,
        num_highway: int = 4,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.cbhg = CBHG(
            in_units=in_units,
            out_units=cbhg_out_units,
            conv_channels=conv_channels,
            max_filter_width=max_filter_width,
            projection1_out_channels=projection1_out_channels,
            projection2_out_channels=in_units,
            num_highway=num_highway,
            use_pallas=use_pallas,
        )
        self.linear = Dense(cbhg_out_units, out_dim)

    def forward(self, mel: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return self.linear(self.cbhg(mel, lengths))
