"""Encoders: the dual-stream self-attention CBHG encoder and its accent variant.

Counterpart of ``self_attention_tacotron_tpu/models/encoders.py``. Encoders
take already-embedded inputs (B, T, D) and lengths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from self_attention_tacotron_torch.models.modules import CBHG, PreNet, sequence_mask
from self_attention_tacotron_torch.models.self_attention import SelfAttentionTransformer


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
        memory2, sa_alignments = self.self_attention(memory1, mask=mask)
        return memory1, memory2, sa_alignments


class SelfAttentionCBHGEncoderWithAccentType(SelfAttentionCBHGEncoder):
    """Dual-stream encoder with the accent-type embedding concatenated to the input."""

    def forward(self, embedded, accent_embedded, lengths, generator=None):  # type: ignore[override]
        return super().forward(
            torch.cat([embedded, accent_embedded], dim=-1), lengths, generator=generator
        )


def encoder_factory(hparams) -> nn.Module:
    """Map ``hparams.encoder`` to an encoder instance."""
    name = hparams.encoder
    if name in ("SelfAttentionCBHGEncoder", "SelfAttentionCBHGEncoderWithAccentType"):
        with_accent = name.endswith("WithAccentType")
        cls = SelfAttentionCBHGEncoderWithAccentType if with_accent else SelfAttentionCBHGEncoder
        in_units = hparams.embedding_dim + (
            hparams.accent_type_embedding_dim if with_accent else 0
        )
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
    if name in ("ZoneoutEncoderV1", "ZoneoutEncoderV1WithAccentType", "EncoderV1"):
        raise NotImplementedError(f"encoder {name!r} is not ported yet")
    raise ValueError(f"unknown encoder: {name!r}")
