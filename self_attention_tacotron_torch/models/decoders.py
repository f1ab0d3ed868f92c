"""Autoregressive attention decoder: single or dual source, with or without self-attention.

Counterpart of ``self_attention_tacotron_tpu/models/decoders.py`` for the four
decoders (``ExtendedDecoder``, ``SelfAttentionDecoder``,
``DualSourceDecoder``, ``DualSourceSelfAttentionDecoder``), each with the mel head
or, under the ``MgcLf0`` prefix, the WORLD heads ``mgc`` and ``lf0``: prenet -> attention
LSTM -> attention mechanism(s) -> decoder ZoneoutLSTM stack per step, then the
output head, with a K/V-cached self-attention block where the decoder has one.
All recurrence state is carried explicitly in :class:`DecoderState`.

``forward(cond, targets)`` is the teacher-forced pass of training and
evaluation. On a CUDA device, with ``use_pallas`` and a decoder of the family
``ops/fused_teacher.py`` serves, the scanned region runs as that module's two
kernels, in float32 or bfloat16 as the decoder computes (or raises); a
location-sensitive mechanism hands them its convolution and dense layer folded
into one map of the taps (``location_fold``), under autograd, so that the
kernels' gradients of the fold reach the convolution, the dense layer and the
bias as the JAX package's autodiff takes them there;
otherwise, and on the CPU, it is a Python loop over ``step`` under autograd.
Both paths draw the prenet's dropout masks and the zoneout masks' seed from one
generator in one order and build the zoneout masks from the same hash, so they
compute the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from self_attention_tacotron_torch.models.attention import (
    AdditiveAttention,
    AttentionState,
    ForwardAttention,
    LocationSensitiveAttention,
    TeacherForcingAttention,
    initial_attention_state,
    location_fold,
)
from self_attention_tacotron_torch.models.modules import (
    Dense,
    LSTMCarry,
    PreNet,
    ZoneoutLSTMCell,
)
from self_attention_tacotron_torch.models.self_attention import SelfAttentionTransformer
from self_attention_tacotron_torch.ops import fused_teacher
from self_attention_tacotron_torch.parallel import shard


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
    teacher_ratio: Optional[torch.Tensor] = None  # (B,) for forced alignment


class Decoder(nn.Module):
    """Parameterised AR decoder; named decoders are configurations of it.

    ``output_heads``: ((name, dim), ...). The frame block fed back through the
    prenet is the concatenation of all heads. ``memory_units`` gives the width
    of each attention source and ``speaker_units`` that of the speaker
    embedding appended to the prenet output (0 for none). The recurrent state and
    the contexts are in the compute dtype, the attention state float32.
    """

    compute_dtype = torch.float32

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
        use_pallas: bool = False,
    ):
        super().__init__()
        self.use_pallas = use_pallas
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
        self.output_projection = Dense(head_in, r * self.out_dim + r)
        # dual-source: the query projections of both mechanisms as one product
        self.query_projection = (
            Dense(
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
        batch, device, dtype = mem0.shape[0], mem0.device, self.compute_dtype
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
        x = self.prenet(feed.to(self.compute_dtype), dropout_masks=prenet_masks,
                        generator=generator)
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
            kwargs = {"projected_query": projected_queries[i]}
            if isinstance(mech, TeacherForcingAttention):
                kwargs["ratio"] = cond.teacher_ratio
            ctx, probs, new_as = mech(
                query,
                cond.keys[i],
                cond.memories[i],
                cond.masks[i],
                state.attention_states[i],
                **kwargs,
            )
            contexts.append(ctx)
            aligns.append(probs)
            new_att_states.append(new_as)

        out = torch.cat([query, *contexts], dim=-1).to(self.compute_dtype)
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
    # Output head: full sequence (training) and one step at a time
    # ------------------------------------------------------------------ #

    def post(self, features: torch.Tensor, generator: Optional[torch.Generator] = None):
        """features: (B, N, D) scanned step outputs -> frames and stop logits.

        Returns ``({head: (B, N * r, dim)}, stop (B, N * r), sa_alignments)``.
        """
        sa_aligns = []
        if self.self_attention is not None:
            features, sa_aligns = self.self_attention(
                features, mask=None, causal=True, generator=generator
            )
        b, n, _ = features.shape
        r = self.outputs_per_step
        block = self.output_projection(features)          # (B, N, r * out_dim + r)
        frame_block = block[..., : r * self.out_dim].reshape(b, n * r, self.out_dim)
        stop = block[..., r * self.out_dim :].reshape(b, n * r)
        return self._split_heads(frame_block), stop, sa_aligns

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

    # ------------------------------------------------------------------ #
    # Teacher-forced decode (training and evaluation)
    # ------------------------------------------------------------------ #

    def make_teacher_feeds(self, targets: torch.Tensor) -> torch.Tensor:
        """targets: (B, T, out_dim), T a multiple of r -> feeds (B, N, n_feed * out_dim).

        Step n is fed the last ``n_feed_frame`` ground-truth frames of group
        n - 1, and step 0 the go frame of zeros.
        """
        b, t, m = targets.shape
        r = self.outputs_per_step
        if t % r != 0:
            raise ValueError("targets must be padded to a multiple of outputs_per_step")
        n = t // r
        groups = targets.reshape(b, n, r, m)
        prev = groups[:, :-1, r - self.n_feed_frame :, :].reshape(b, n - 1, -1)
        go = torch.zeros(b, 1, self.n_feed_frame * m, dtype=targets.dtype, device=targets.device)
        return torch.cat([go, prev], dim=1)

    def fused_teacher_supported(self) -> bool:
        """Whether this decoder is of the family the teacher kernels serve: forward
        attention on source 1, and on source 2, where there is one, additive; or
        location-sensitive attention with an odd number of taps up to
        ``fused_teacher.MAX_TAPS``, on every decoder: the decoder self-attention
        sits outside the scan (``post``), so the kernels of one and of two sources
        serve the decoders with it and without it alike. A teacher-forcing
        mechanism is served in train mode, where it is the mechanism it stands for
        (the JAX package's training network builds that one), and not in eval
        mode, where it is the forced window (its prediction network's)."""
        mechs = self.attentions
        if len(mechs) == 1:
            sources_ok = mechs[0].query_layer is not None
        else:
            sources_ok = (
                len(mechs) == 2
                and isinstance(mechs[1], AdditiveAttention)
                and self.query_projection is not None
            )
        mech1 = mechs[0]
        if isinstance(mech1, LocationSensitiveAttention):
            mech_ok = fused_teacher.taps_supported(mech1.attention_kernel)
        else:
            mech_ok = isinstance(mech1, ForwardAttention)
        if any(isinstance(m, TeacherForcingAttention) and not m.training for m in mechs):
            mech_ok = False
        return (
            sources_ok
            and mech_ok
            and len(self.prenet.out_units) == 2
            and self.num_decoder_layers == 2
            and all(u % 4 == 0 for u in self.memory_units)
            and self.attention_rnn_out_units + sum(self.memory_units) != self.decoder_out_units
        )

    def _teacher_hp_like(self) -> Dict:
        mech1 = self.attentions[0]
        dual = self.num_attentions == 2
        ls = isinstance(mech1, LocationSensitiveAttention)
        return dict(
            dual=dual, use_ta=getattr(mech1, "transition_factor", None) is not None,
            att_units=self.attention_rnn_out_units, att1_units=mech1.num_units,
            att2_units=self.attentions[1].num_units if dual else 0,
            dec_units=self.decoder_out_units,
            zoneout_cell=self.attention_lstm.zoneout_factor_cell,
            zoneout_output=self.attention_lstm.zoneout_factor_output,
            forget_bias=self.attention_lstm.forget_bias,
            prenet_drop_rate=self.prenet.drop_rate,
            io_dtype="bfloat16" if self.compute_dtype == torch.bfloat16 else "float32",
            src1_kind="location_sensitive" if ls else "forward",
            ls_cumulative=bool(mech1.cumulative_weights) if ls else True,
            ls_kernel=int(mech1.attention_kernel) if ls else 0,
            eval_zoneout=not self.training,
            lane0=shard.lane_offset(),
        )

    def teacher_operands(self, cond: DecoderConditioning) -> Dict:
        """What ``fused_teacher.teacher_decode`` takes besides feeds, seed and masks.

        Dual source: ``vblk`` from the two score vectors, ``w_qp`` the fused query
        projection, both mechanisms' keys side by side. One source: ``vblk`` is the
        score vector, ``w_qp`` the mechanism's own query layer, and there is no
        second key or memory. A location-sensitive mechanism adds its folded taps
        ``w_lsW`` (K, A1) and ``ls_bias`` (A1,) (``location_fold``). The key mask
        becomes a bias. Keys and memories are in the compute dtype, the weights and
        the speaker embedding float32 (the kernels round them)."""
        mech1 = self.attentions[0]
        dual = self.num_attentions == 2
        v1 = mech1.attention_v
        e1 = self.memory_units[0]
        agent = getattr(mech1, "transition_factor", None)
        if agent is not None:
            w_ta, b_ta = agent.weight.t(), agent.bias
        else:
            w_ta = v1.new_zeros(e1 + self.attention_rnn_out_units, 1)
            b_ta = v1.new_zeros(1)
        weights = dict(
            w_p1=self.prenet.Dense_0.weight.t(), b_p1=self.prenet.Dense_0.bias,
            w_p2=self.prenet.Dense_1.weight.t(), b_p2=self.prenet.Dense_1.bias,
            w_attg=self.attention_lstm.gates.weight.t(), b_attg=self.attention_lstm.gates.bias,
            w_ta=w_ta, b_ta=b_ta,
            w_l1=self.decoder_lstm_0.gates.weight.t(), b_l1=self.decoder_lstm_0.gates.bias,
            w_l2=self.decoder_lstm_1.gates.weight.t(), b_l2=self.decoder_lstm_1.gates.bias,
        )
        if isinstance(mech1, LocationSensitiveAttention):
            weights["w_lsW"], weights["ls_bias"] = location_fold(mech1)
        if dual:
            v2 = self.attentions[1].attention_v
            weights["w_qp"] = self.query_projection.weight.t()
            weights["vblk"] = torch.cat([
                torch.cat([v1, torch.zeros_like(v1)], dim=1),
                torch.cat([torch.zeros_like(v2), v2], dim=1),
            ], dim=0)
            mem1, mem2 = (m.to(self.compute_dtype) for m in cond.memories)
        else:
            weights["w_qp"] = mech1.query_layer.weight.t()
            weights["vblk"] = v1
            mem1, mem2 = cond.memories[0].to(self.compute_dtype), None
        mask = cond.masks[0]
        if mask is None:
            score_bias = torch.zeros(mem1.shape[:2], dtype=torch.float32, device=mem1.device)
        else:
            score_bias = torch.where(mask, 0.0, -1e9).to(torch.float32)
        spk = cond.speaker_embed
        return dict(
            weights=weights, keys=torch.cat(cond.keys, dim=-1).to(self.compute_dtype),
            mem1=mem1, mem2=mem2,
            score_bias=score_bias, spk=None if spk is None else spk.to(torch.float32),
            hp_like=self._teacher_hp_like(),
        )

    def _fused_teacher_call(self, cond: DecoderConditioning, feeds, prenet_masks, seed: int):
        """The scanned region through ``ops/fused_teacher.py``; the features (float32
        there) in the compute dtype, as ``post`` takes them."""
        features, aligns = fused_teacher.teacher_decode(
            **self.teacher_operands(cond), feeds=feeds, seed=seed, prenet_masks=prenet_masks
        )
        features = features.to(self.compute_dtype)
        if self.num_attentions == 1:
            return features, (aligns,)
        s = cond.memories[0].shape[1]
        return features, (aligns[..., :s], aligns[..., s:])

    def draw_teacher_masks(self, batch: int, steps: int, device,
                           generator: Optional[torch.Generator] = None):
        """``(prenet keep masks or None, zoneout)`` for one teacher-forced pass.

        One call per prenet layer, then the zoneout of the pass. With two decoder
        LSTMs (the kernels' structure) ``zoneout`` is the seed that all its masks
        come from (``fused_teacher.hash_keep_masks``), one draw. With any other
        count it is the masks themselves, as JAX's XLA scan draws them: per cell
        (the attention LSTM, then the decoder LSTMs) a cell and an output mask of
        (steps, batch, units), each where its factor is above 0 (True: keep the
        previous state), one call each. In eval mode and at zoneout 0 it is 0, and
        nothing is drawn.
        """
        prenet_masks = None
        if self.prenet.drop_rate > 0.0:
            keep = 1.0 - self.prenet.drop_rate
            prenet_masks = tuple(
                shard.rand((batch, steps, units), device, generator) < keep
                for units in self.prenet.out_units
            )
        zc, zo = self._zoneout_factors()
        if not self.training or (zc, zo) == (0.0, 0.0):
            return prenet_masks, 0
        if self.num_decoder_layers == 2:
            return prenet_masks, int(
                torch.randint(0, 2**31 - 1, (1,), device=device, generator=generator))
        units = [self.attention_rnn_out_units] + [self.decoder_out_units] * self.num_decoder_layers

        def draw(factor, width):
            if factor <= 0.0:
                return None
            return (shard.rand((batch, steps, width), device, generator) < factor).transpose(0, 1)

        return prenet_masks, tuple((draw(zc, u), draw(zo, u)) for u in units)

    def _zoneout_factors(self) -> Tuple[float, float]:
        cell = self.attention_lstm
        return max(cell.zoneout_factor_cell, 0.0), max(cell.zoneout_factor_output, 0.0)

    def _plain_teacher_scan(self, cond: DecoderConditioning, feeds, prenet_masks, zoneout):
        """The scanned region as a Python loop over ``step`` under autograd.
        ``zoneout`` is ``draw_teacher_masks``'s: a seed or the cells' masks."""
        b, n = feeds.shape[:2]
        zc, zo = self._zoneout_factors()
        seed, zoneout = (zoneout, None) if isinstance(zoneout, int) else (0, zoneout)
        if zoneout is None and self.training and (zc > 0.0 or zo > 0.0):
            if self.num_decoder_layers != 2:
                raise ValueError(f"{self.num_decoder_layers} decoder LSTMs take the zoneout "
                                 "masks draw_teacher_masks draws, not a seed")
            zoneout = [
                tuple(None if m is None else m > 0.5 for m in pair)
                for pair in fused_teacher.zoneout_keep_masks(
                    dict(zoneout_cell=zc, zoneout_output=zo,
                         att_units=self.attention_rnn_out_units,
                         dec_units=self.decoder_out_units, lane0=shard.lane_offset()),
                    seed, n, b, feeds.device,
                )
            ]
        state = self.initial_state(cond)
        features, aligns = [], []
        for t in range(n):
            state, (feature, align) = self.step(
                state, feeds[:, t], cond,
                prenet_masks=None if prenet_masks is None else [m[:, t] for m in prenet_masks],
                zoneout_masks=None if zoneout is None else [
                    tuple(None if m is None else m[t] for m in pair) for pair in zoneout
                ],
            )
            features.append(feature)
            aligns.append(align)
        return torch.stack(features, dim=1), tuple(torch.stack(a, dim=1) for a in zip(*aligns))

    def forward(self, cond: DecoderConditioning, targets: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced pass.

        Returns ``({head: frames}, stop_logits (B, T), alignments ((B, N, S_i) per
        source), sa_alignments)``. The prenet's dropout masks are drawn in one
        call per layer; in train mode the zoneout masks of all steps come from
        one seed (``fused_teacher.hash_keep_masks``) with two decoder LSTMs, and
        are drawn one call per cell and kind with any other count
        (``draw_teacher_masks``); in eval mode zoneout is the deterministic
        interpolation.
        """
        feeds = self.make_teacher_feeds(targets)
        kernels = self.use_pallas and feeds.device.type != "cpu" and self.fused_teacher_supported()
        prenet_masks, zoneout = self.draw_teacher_masks(*feeds.shape[:2], feeds.device, generator)
        if kernels:
            features, aligns = self._fused_teacher_call(cond, feeds, prenet_masks, zoneout)
        else:
            features, aligns = self._plain_teacher_scan(cond, feeds, prenet_masks, zoneout)
        frames, stop, sa_aligns = self.post(features, generator=generator)
        return frames, stop, aligns, sa_aligns


def mel_heads(hparams) -> Tuple[Tuple[str, int], ...]:
    return (("mel", hparams.num_mels),)


def mgc_lf0_heads(hparams) -> Tuple[Tuple[str, int], ...]:
    return (("mgc", hparams.num_mgcs), ("lf0", hparams.num_lf0s))


# decoder name -> (attention sources, decoder self-attention)
DECODERS = {
    "ExtendedDecoder": (1, False),
    "SelfAttentionDecoder": (1, True),
    "DualSourceDecoder": (2, False),
    "DualSourceSelfAttentionDecoder": (2, True),
}
MGC_LF0 = "MgcLf0"


def base_decoder(name: str) -> str:
    """The decoder's name without the ``MgcLf0`` prefix, a key of :data:`DECODERS` if known."""
    return name[len(MGC_LF0):] if name.startswith(MGC_LF0) else name


def decoder_factory(
    hparams,
    attention_mechs: Sequence[nn.Module],
    memory_units: Sequence[int],
    speaker_units: int = 0,
) -> Decoder:
    """Map ``hparams.decoder`` to a configured :class:`Decoder`: the four decoders,
    with the mel head or, named with the ``MgcLf0`` prefix, the mgc and lf0 heads."""
    name = hparams.decoder
    mgc_lf0 = name.startswith(MGC_LF0)
    base = base_decoder(name)
    if base not in DECODERS:
        raise ValueError(f"unknown decoder: {name!r}")
    expected_sources, use_sa = DECODERS[base]
    if len(attention_mechs) != expected_sources:
        raise ValueError(
            f"{name} expects {expected_sources} attention mechanism(s), "
            f"got {len(attention_mechs)}"
        )
    return Decoder(
        attention_mechs=attention_mechs,
        memory_units=memory_units,
        output_heads=mgc_lf0_heads(hparams) if mgc_lf0 else mel_heads(hparams),
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
        use_pallas=hparams.use_pallas_kernels,
    )
