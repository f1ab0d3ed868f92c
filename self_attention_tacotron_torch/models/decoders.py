"""Autoregressive attention decoder (dual-source, with decoder self-attention).

Counterpart of ``self_attention_tacotron_tpu/models/decoders.py`` for the
flagship's ``DualSourceSelfAttentionDecoder``: prenet -> attention LSTM ->
attention mechanism(s) -> decoder ZoneoutLSTM stack per step, then the output
head with its K/V-cached self-attention block. All recurrence state is carried
explicitly in :class:`DecoderState`. The teacher-forced full-sequence pass is
not part of this module yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from self_attention_tacotron_torch.models.attention import (
    AttentionState,
    initial_attention_state,
)
from self_attention_tacotron_torch.models.modules import LSTMCarry, PreNet, ZoneoutLSTMCell
from self_attention_tacotron_torch.models.self_attention import SelfAttentionTransformer


@dataclasses.dataclass
class DecoderState:
    """Full recurrence state of one decoder step."""

    attention_lstm: LSTMCarry
    decoder_lstms: Tuple[LSTMCarry, ...]
    attention_states: Tuple[AttentionState, ...]
    contexts: Tuple[torch.Tensor, ...]
    time: int


@dataclasses.dataclass
class DecoderConditioning:
    """Per-utterance conditioning visible to every decoder step."""

    memories: Tuple[torch.Tensor, ...]            # one (B, S, E_i) per attention source
    keys: Tuple[torch.Tensor, ...]                # precomputed attention keys
    masks: Tuple[Optional[torch.Tensor], ...]
    speaker_embed: Optional[torch.Tensor] = None  # (B, D_spk) or None


class Decoder(nn.Module):
    """Parameterised AR decoder; named decoders are configurations of it.

    ``output_heads``: ((name, dim), ...). The frame block fed back through the
    prenet is the concatenation of all heads. ``memory_units`` gives the width
    of each attention source and ``speaker_units`` that of the speaker
    embedding appended to the prenet output (0 for none).
    """

    def __init__(
        self,
        attention_mechs: Sequence[nn.Module],
        memory_units: Sequence[int],
        output_heads: Tuple[Tuple[str, int], ...] = (("mel", 80),),
        outputs_per_step: int = 2,
        n_feed_frame: int = 1,
        prenet_out_units: Tuple[int, ...] = (256, 128),
        prenet_drop_rate: float = 0.5,
        attention_rnn_out_units: int = 256,
        decoder_out_units: int = 256,
        num_decoder_layers: int = 2,
        zoneout_factor_cell: float = 0.1,
        zoneout_factor_output: float = 0.1,
        use_self_attention: bool = False,
        self_attention_out_units: int = 256,
        self_attention_num_heads: int = 2,
        self_attention_num_hop: int = 1,
        self_attention_drop_rate: float = 0.05,
        self_attention_ffn_units: int = 1024,
        speaker_units: int = 0,
    ):
        super().__init__()
        self.output_heads = tuple(output_heads)
        self.out_dim = sum(dim for _, dim in self.output_heads)
        self.outputs_per_step = outputs_per_step
        self.n_feed_frame = n_feed_frame
        self.attention_rnn_out_units = attention_rnn_out_units
        self.decoder_out_units = decoder_out_units
        self.num_decoder_layers = num_decoder_layers
        self.num_attentions = len(attention_mechs)
        self.memory_units = tuple(memory_units)

        self.prenet = PreNet(n_feed_frame * self.out_dim, prenet_out_units, prenet_drop_rate)
        for i, mech in enumerate(attention_mechs):
            self.add_module(f"attention_{i}", mech)
        att_in = prenet_out_units[-1] + speaker_units + sum(self.memory_units)
        self.attention_lstm = ZoneoutLSTMCell(
            att_in, attention_rnn_out_units, zoneout_factor_cell, zoneout_factor_output
        )
        width = attention_rnn_out_units + sum(self.memory_units)
        for i in range(num_decoder_layers):
            self.add_module(
                f"decoder_lstm_{i}",
                ZoneoutLSTMCell(
                    width, decoder_out_units, zoneout_factor_cell, zoneout_factor_output
                ),
            )
            width = decoder_out_units
        self.self_attention = (
            SelfAttentionTransformer(
                in_units=width,
                num_hop=self_attention_num_hop,
                num_heads=self_attention_num_heads,
                num_units=self_attention_out_units,
                ffn_units=self_attention_ffn_units,
                drop_rate=self_attention_drop_rate,
            )
            if use_self_attention else None
        )
        head_in = self_attention_out_units if use_self_attention else width
        r = outputs_per_step
        # one fused output product: [r x (all head dims) | r stop logits]
        self.output_projection = nn.Linear(head_in, r * self.out_dim + r)
        # dual-source: the query projections of both mechanisms as one product
        self.query_projection = (
            nn.Linear(
                attention_rnn_out_units, sum(m.num_units for m in attention_mechs), bias=False
            )
            if len(attention_mechs) > 1 else None
        )

    @property
    def attentions(self) -> Tuple[nn.Module, ...]:
        return tuple(getattr(self, f"attention_{i}") for i in range(self.num_attentions))

    @property
    def decoder_lstms(self) -> Tuple[ZoneoutLSTMCell, ...]:
        return tuple(getattr(self, f"decoder_lstm_{i}") for i in range(self.num_decoder_layers))

    # ------------------------------------------------------------------ #
    # State
    # ------------------------------------------------------------------ #

    def initial_state(self, cond: DecoderConditioning) -> DecoderState:
        mem0 = cond.memories[0]
        batch, device, dtype = mem0.shape[0], mem0.device, mem0.dtype
        att_states = tuple(
            initial_attention_state(
                batch, mem.shape[1], initial_alignment=mech.initial_alignment, device=device
            )
            for mech, mem in zip(self.attentions, cond.memories)
        )
        contexts = tuple(
            torch.zeros(batch, mem.shape[2], dtype=dtype, device=device) for mem in cond.memories
        )
        return DecoderState(
            attention_lstm=ZoneoutLSTMCell.initial_state(
                batch, self.attention_rnn_out_units, dtype, device
            ),
            decoder_lstms=tuple(
                ZoneoutLSTMCell.initial_state(batch, self.decoder_out_units, dtype, device)
                for _ in range(self.num_decoder_layers)
            ),
            attention_states=att_states,
            contexts=contexts,
            time=0,
        )

    def compute_keys(self, memories: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return tuple(mech.compute_keys(mem) for mech, mem in zip(self.attentions, memories))

    def go_frame(self, batch: int, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.n_feed_frame * self.out_dim, dtype=dtype, device=device)

    # ------------------------------------------------------------------ #
    # One step of the wrapped-cell stack
    # ------------------------------------------------------------------ #

    def step(
        self,
        state: DecoderState,
        feed: torch.Tensor,
        cond: DecoderConditioning,
        prenet_masks=None,
        zoneout_masks=None,
        generator: Optional[torch.Generator] = None,
    ):
        """feed: (B, n_feed_frame * out_dim) previous frame(s).

        ``prenet_masks``: optional per-layer dropout keep-masks for this step.
        ``zoneout_masks``: optional per-cell (keep_c, keep_h) masks, ordered
        (attention_lstm, *decoder_lstms), for train mode.
        Returns ``(new_state, (feature, alignments))``.
        """
        zm = zoneout_masks or (None,) * (1 + self.num_decoder_layers)
        x = self.prenet(feed, dropout_masks=prenet_masks, generator=generator)
        if cond.speaker_embed is not None:
            x = torch.cat([x, cond.speaker_embed.to(x.dtype)], dim=-1)
        att_in = torch.cat([x, *state.contexts], dim=-1)
        new_att_lstm, query = self.attention_lstm(
            state.attention_lstm, att_in, zoneout_masks=zm[0], generator=generator
        )

        projected_queries = [None] * self.num_attentions
        if self.query_projection is not None:
            fused = self.query_projection(query)
            offset = 0
            for i, mech in enumerate(self.attentions):
                projected_queries[i] = fused[:, offset : offset + mech.num_units]
                offset += mech.num_units

        contexts, aligns, new_att_states = [], [], []
        for i, mech in enumerate(self.attentions):
            ctx, probs, new_as = mech(
                query,
                cond.keys[i],
                cond.memories[i],
                cond.masks[i],
                state.attention_states[i],
                projected_query=projected_queries[i],
            )
            contexts.append(ctx)
            aligns.append(probs)
            new_att_states.append(new_as)

        out = torch.cat([query, *contexts], dim=-1)
        new_dec_states = []
        for i, (cell, carry) in enumerate(zip(self.decoder_lstms, state.decoder_lstms)):
            new_carry, y = cell(carry, out, zoneout_masks=zm[1 + i], generator=generator)
            new_dec_states.append(new_carry)
            out = y + out if y.shape == out.shape else y  # residual when widths match

        new_state = DecoderState(
            attention_lstm=new_att_lstm,
            decoder_lstms=tuple(new_dec_states),
            attention_states=tuple(new_att_states),
            contexts=tuple(contexts),
            time=state.time + 1,
        )
        return new_state, (out, tuple(aligns))

    # ------------------------------------------------------------------ #
    # Output head, one step at a time
    # ------------------------------------------------------------------ #

    def _split_heads(self, frame_block: torch.Tensor) -> Dict[str, torch.Tensor]:
        frames = {}
        offset = 0
        for head, dim in self.output_heads:
            frames[head] = frame_block[..., offset : offset + dim]
            offset += dim
        return frames

    def init_caches(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        if self.self_attention is not None:
            return self.self_attention.init_cache(batch, max_len, dtype, device)
        return ()

    def post_step(self, feature: torch.Tensor, caches, index: int):
        """One-step output head. feature: (B, D) -> frame blocks (B, r, dim) + stop (B, r)."""
        if self.self_attention is not None:
            feature, caches = self.self_attention.incremental_step(feature, caches, index)
        r = self.outputs_per_step
        block = self.output_projection(feature)
        frame_block = block[:, : r * self.out_dim].reshape(-1, r, self.out_dim)
        return self._split_heads(frame_block), block[:, r * self.out_dim :], caches


def mel_heads(hparams) -> Tuple[Tuple[str, int], ...]:
    return (("mel", hparams.num_mels),)


def decoder_factory(
    hparams,
    attention_mechs: Sequence[nn.Module],
    memory_units: Sequence[int],
    speaker_units: int = 0,
) -> Decoder:
    """Map ``hparams.decoder`` to a configured :class:`Decoder`."""
    name = hparams.decoder
    if name == "DualSourceSelfAttentionDecoder":
        expected_sources, use_sa = 2, True
    elif name.startswith("MgcLf0") or name in (
        "ExtendedDecoder", "SelfAttentionDecoder", "DualSourceDecoder"
    ):
        raise NotImplementedError(f"decoder {name!r} is not ported yet")
    else:
        raise ValueError(f"unknown decoder: {name!r}")
    if len(attention_mechs) != expected_sources:
        raise ValueError(
            f"{name} expects {expected_sources} attention mechanism(s), "
            f"got {len(attention_mechs)}"
        )
    return Decoder(
        attention_mechs=attention_mechs,
        memory_units=memory_units,
        output_heads=mel_heads(hparams),
        outputs_per_step=hparams.outputs_per_step,
        n_feed_frame=hparams.n_feed_frame,
        prenet_out_units=hparams.decoder_prenet_out_units,
        prenet_drop_rate=hparams.decoder_prenet_drop_rate,
        attention_rnn_out_units=hparams.attention_out_units,
        decoder_out_units=hparams.decoder_out_units,
        zoneout_factor_cell=hparams.zoneout_factor_cell,
        zoneout_factor_output=hparams.zoneout_factor_output,
        use_self_attention=use_sa,
        self_attention_out_units=hparams.decoder_self_attention_out_units,
        self_attention_num_heads=hparams.decoder_self_attention_num_heads,
        self_attention_num_hop=hparams.decoder_self_attention_num_hop,
        self_attention_drop_rate=hparams.decoder_self_attention_drop_rate,
        speaker_units=speaker_units,
    )
