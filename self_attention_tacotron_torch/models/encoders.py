"""Encoders: the baseline's single-stream encoders and the dual-stream self-attention one.

Counterpart of ``self_attention_tacotron_tpu/models/encoders.py``. Encoders
take already-embedded inputs (B, T, D) and lengths. ``ZoneoutEncoderV1``
(prenet -> bidirectional ZoneoutLSTM) and ``EncoderV1`` (prenet -> CBHG) return
one memory; ``SelfAttentionCBHGEncoder`` returns the two streams of dual-source
attention and the self-attention alignments. The ``...WithAccentType`` variants
concatenate an accent-type embedding to the symbol embedding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from self_attention_tacotron_torch.models.modules import (
    CBHG,
    BiRNN,
    PreNet,
    ZoneoutLSTMCell,
    sequence_mask,
)
from self_attention_tacotron_torch.models.self_attention import SelfAttentionTransformer


class ZoneoutEncoderV1(nn.Module):
    """Prenet -> bidirectional ZoneoutLSTM, ``out_units // 2`` units a direction."""

    # where the JAX package's parameter tree names a sub-module otherwise
    flax_aliases = {"lstm_fwd": "birnn.cell_fwd", "lstm_bwd": "birnn.cell_bwd"}

    def __init__(
        self,
        in_units: int,
        out_units: int = 256,
        prenet_out_units: Tuple[int, ...] = (256, 128),
        drop_rate: float = 0.5,
        zoneout_factor_cell: float = 0.1,
        zoneout_factor_output: float = 0.1,
        use_pallas: bool = False,
    ):
        super().__init__()
        if out_units % 2:
            raise ValueError("out_units is split over two directions: it must be even")
        self.prenet = PreNet(in_units, prenet_out_units, drop_rate)
        half = out_units // 2
        cells = [
            ZoneoutLSTMCell(prenet_out_units[-1], half, zoneout_factor_cell, zoneout_factor_output)
            for _ in range(2)
        ]
        self.birnn = BiRNN(*cells, use_pallas=use_pallas)

    def forward(self, embedded: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.prenet(embedded, generator=generator)
        return self.birnn(x, lengths, generator=generator)


class ZoneoutEncoderV1WithAccentType(ZoneoutEncoderV1):
    """``ZoneoutEncoderV1`` with the accent-type embedding concatenated to the input."""

    def forward(self, embedded, accent_embedded, lengths, generator=None):  # type: ignore[override]
        return super().forward(
            torch.cat([embedded, accent_embedded], dim=-1), lengths, generator=generator
        )


class EncoderV1(nn.Module):
    """Prenet -> CBHG (the Tacotron v1 encoder)."""

    def __init__(
        self,
        in_units: int,
        cbhg_out_units: int = 256,
        conv_channels: int = 128,
        max_filter_width: int = 16,
        projection1_out_channels: int = 128,
        projection2_out_channels: int = 128,
        num_highway: int = 4,
        prenet_out_units: Tuple[int, ...] = (256, 128),
        drop_rate: float = 0.5,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.prenet = PreNet(in_units, prenet_out_units, drop_rate)
        self.cbhg = CBHG(
            in_units=prenet_out_units[-1],
            out_units=cbhg_out_units,
            conv_channels=conv_channels,
            max_filter_width=max_filter_width,
            projection1_out_channels=projection1_out_channels,
            projection2_out_channels=projection2_out_channels,
            num_highway=num_highway,
            use_pallas=use_pallas,
        )

    def forward(self, embedded: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.cbhg(self.prenet(embedded, generator=generator), lengths)


class SelfAttentionCBHGEncoder(nn.Module):
    """Prenet -> CBHG -> memory 1; self-attention stack over it -> memory 2.

    Returns ``(memory1, memory2, sa_alignments)``, the two streams of
    dual-source attention.
    """

    def __init__(
        self,
        in_units: int,
        cbhg_out_units: int = 256,
        conv_channels: int = 128,
        max_filter_width: int = 16,
        projection1_out_channels: int = 128,
        projection2_out_channels: int = 128,
        num_highway: int = 4,
        prenet_out_units: Tuple[int, ...] = (256, 128),
        drop_rate: float = 0.5,
        self_attention_out_units: int = 256,
        self_attention_num_heads: int = 2,
        self_attention_num_hop: int = 1,
        self_attention_drop_rate: float = 0.05,
        self_attention_ffn_units: int = 1024,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.prenet = PreNet(in_units, prenet_out_units, drop_rate)
        self.cbhg = CBHG(
            in_units=prenet_out_units[-1],
            out_units=cbhg_out_units,
            conv_channels=conv_channels,
            max_filter_width=max_filter_width,
            projection1_out_channels=projection1_out_channels,
            projection2_out_channels=projection2_out_channels,
            num_highway=num_highway,
            use_pallas=use_pallas,
        )
        self.self_attention = SelfAttentionTransformer(
            in_units=cbhg_out_units,
            num_hop=self_attention_num_hop,
            num_heads=self_attention_num_heads,
            num_units=self_attention_out_units,
            ffn_units=self_attention_ffn_units,
            drop_rate=self_attention_drop_rate,
            use_pallas=use_pallas,
        )

    def forward(
        self,
        embedded: torch.Tensor,
        lengths: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ):
        memory1 = self.cbhg(self.prenet(embedded, generator=generator), lengths)
        mask = sequence_mask(lengths, embedded.shape[1])
        memory2, sa_alignments = self.self_attention(memory1, mask=mask, generator=generator)
        return memory1, memory2, sa_alignments


class SelfAttentionCBHGEncoderWithAccentType(SelfAttentionCBHGEncoder):
    """Dual-stream encoder with the accent-type embedding concatenated to the input."""

    def forward(self, embedded, accent_embedded, lengths, generator=None):  # type: ignore[override]
        return super().forward(
            torch.cat([embedded, accent_embedded], dim=-1), lengths, generator=generator
        )


def encoder_out_units(hparams) -> int:
    """Width of the (first) memory that ``hparams.encoder`` hands the decoder."""
    if hparams.encoder.startswith("ZoneoutEncoderV1"):
        return hparams.encoder_out_units
    return hparams.cbhg_out_units


def encoder_factory(hparams) -> nn.Module:
    """Map ``hparams.encoder`` to an encoder instance."""
    name = hparams.encoder
    in_units = hparams.embedding_dim + (
        hparams.accent_type_embedding_dim if name.endswith("WithAccentType") else 0
    )
    if name in ("ZoneoutEncoderV1", "ZoneoutEncoderV1WithAccentType"):
        with_accent = name.endswith("WithAccentType")
        cls = ZoneoutEncoderV1WithAccentType if with_accent else ZoneoutEncoderV1
        return cls(
            in_units=in_units,
            out_units=hparams.encoder_out_units,
            prenet_out_units=hparams.encoder_prenet_out_units,
            drop_rate=hparams.encoder_prenet_drop_rate,
            zoneout_factor_cell=hparams.zoneout_factor_cell,
            zoneout_factor_output=hparams.zoneout_factor_output,
            use_pallas=hparams.use_pallas_kernels,
        )
    if name == "EncoderV1":
        return EncoderV1(
            in_units=in_units,
            cbhg_out_units=hparams.cbhg_out_units,
            conv_channels=hparams.conv_channels,
            max_filter_width=hparams.max_filter_width,
            projection1_out_channels=hparams.projection1_out_channels,
            projection2_out_channels=hparams.projection2_out_channels,
            num_highway=hparams.num_highway,
            prenet_out_units=hparams.encoder_prenet_out_units,
            drop_rate=hparams.encoder_prenet_drop_rate,
            use_pallas=hparams.use_pallas_kernels,
        )
    if name in ("SelfAttentionCBHGEncoder", "SelfAttentionCBHGEncoderWithAccentType"):
        with_accent = name.endswith("WithAccentType")
        cls = SelfAttentionCBHGEncoderWithAccentType if with_accent else SelfAttentionCBHGEncoder
        return cls(
            in_units=in_units,
            cbhg_out_units=hparams.cbhg_out_units,
            conv_channels=hparams.conv_channels,
            max_filter_width=hparams.max_filter_width,
            projection1_out_channels=hparams.projection1_out_channels,
            projection2_out_channels=hparams.projection2_out_channels,
            num_highway=hparams.num_highway,
            prenet_out_units=hparams.encoder_prenet_out_units,
            drop_rate=hparams.encoder_prenet_drop_rate,
            self_attention_out_units=hparams.self_attention_out_units,
            self_attention_num_heads=hparams.self_attention_num_heads,
            self_attention_num_hop=hparams.self_attention_num_hop,
            self_attention_drop_rate=hparams.self_attention_drop_rate,
            self_attention_ffn_units=hparams.self_attention_transformer_ffn_units,
            use_pallas=hparams.use_pallas_kernels,
        )
    raise ValueError(f"unknown encoder: {name!r}")
