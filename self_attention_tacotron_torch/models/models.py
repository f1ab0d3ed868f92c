"""Top-level network, the flagship model class, and the model factory.

Counterpart of ``self_attention_tacotron_tpu/models/models.py`` for synthesis:
:class:`TacotronNetwork` holds embeddings, encoder and decoder, with ``encode``
and the incremental decode plumbing that ``synthesis.py`` drives. The
teacher-forced forward pass, the losses and the postnets are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.attention import attention_factory
from self_attention_tacotron_torch.models.decoders import (
    Decoder,
    DecoderConditioning,
    decoder_factory,
)
from self_attention_tacotron_torch.models.encoders import encoder_factory
from self_attention_tacotron_torch.models.modules import Embedding, sequence_mask
from self_attention_tacotron_torch.utils.platform import resolve_device, use_full_float32


class TacotronNetwork(nn.Module):
    """Embeddings + encoder + AR decoder, one module."""

    # the JAX package's parameter tree keeps the mechanisms at the top level
    flax_aliases = {"attention_0": "decoder.attention_0", "attention_1": "decoder.attention_1"}

    def __init__(self, hparams: HParams):
        super().__init__()
        hp = hparams
        self.hparams = hp
        if hp.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={hp.compute_dtype!r}: only the float32 model is ported yet"
            )
        if hp.use_postnet_v2 or hp.use_linear_spectrogram_postnet:
            raise NotImplementedError("the postnets are not ported yet")
        self.dual_source = "DualSource" in hp.decoder
        self.embedding = Embedding(hp.num_symbols, hp.embedding_dim)
        if hp.use_accent_type:
            self.accent_embedding = Embedding(
                hp.num_accent_type, hp.accent_type_embedding_dim,
                index_offset=hp.accent_type_offset,
            )
        if hp.use_speaker_embedding:
            self.speaker_embedding = Embedding(
                hp.num_speakers, hp.speaker_embedding_dim,
                index_offset=hp.speaker_embedding_offset,
            )
        self.encoder = encoder_factory(hp)
        if self.dual_source:
            names = (hp.attention, hp.attention2)
            units = (hp.attention1_out_units, hp.attention2_out_units)
            memory_units = (hp.cbhg_out_units, hp.self_attention_out_units)
        else:
            names = (hp.attention,)
            units = (hp.attention1_out_units,)
            memory_units = (hp.cbhg_out_units,)
        mechs = tuple(
            attention_factory(
                n, u, hp,
                query_units=hp.attention_out_units,
                memory_units=m,
                own_query_layer=not self.dual_source,
            )
            for n, u, m in zip(names, units, memory_units)
        )
        self.decoder: Decoder = decoder_factory(
            hp, mechs, memory_units,
            speaker_units=hp.speaker_embedding_dim if hp.use_speaker_embedding else 0,
        )

    def encode(
        self,
        source: torch.Tensor,            # (B, S) integer symbol ids
        source_lengths: torch.Tensor,    # (B,)
        accent_type: Optional[torch.Tensor] = None,
        speaker_id: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns (cond: DecoderConditioning, encoder_sa_alignments)."""
        hp = self.hparams
        embedded = self.embedding(source)
        if hp.use_accent_type:
            if accent_type is None:
                raise ValueError("use_accent_type=True requires accent_type input")
            enc_out = self.encoder(
                embedded, self.accent_embedding(accent_type), source_lengths, generator=generator
            )
        else:
            enc_out = self.encoder(embedded, source_lengths, generator=generator)
        memory1, memory2, sa_aligns = enc_out
        memories = (memory1, memory2) if self.dual_source else (memory1,)

        mask = sequence_mask(source_lengths, source.shape[1])
        masks = tuple(mask for _ in memories)
        speaker_embed = None
        if hp.use_speaker_embedding:
            if speaker_id is None:
                raise ValueError("use_speaker_embedding=True requires speaker_id input")
            speaker_embed = self.speaker_embedding(speaker_id)

        keys = self.decoder.compute_keys(memories)
        cond = DecoderConditioning(
            memories=memories, keys=keys, masks=masks, speaker_embed=speaker_embed
        )
        return cond, tuple(sa_aligns)

    # incremental decode plumbing, used by the synthesis loop

    def decoder_initial_state(self, cond: DecoderConditioning):
        return self.decoder.initial_state(cond)

    def decoder_init_caches(self, batch: int, max_len: int, device=None):
        return self.decoder.init_caches(batch, max_len, torch.float32, device)

    def decoder_go_frame(self, batch: int, device=None):
        return self.decoder.go_frame(batch, torch.float32, device)

    def decoder_step(self, state, feed, cond: DecoderConditioning, prenet_masks=None,
                     generator=None):
        return self.decoder.step(state, feed, cond, prenet_masks=prenet_masks,
                                 generator=generator)

    def decoder_post_step(self, feature, caches, index: int):
        return self.decoder.post_step(feature, caches, index)


class TacotronModelBase:
    """Binds a network configuration to its name (and, later, to its loss)."""

    def __init__(self, hparams: HParams):
        self.hparams = hparams
        self._validate()

    def _validate(self) -> None:
        pass

    def network(self, is_training: bool = False, device="cuda") -> TacotronNetwork:
        """A freshly initialised network on ``device`` (the card unless told otherwise).

        The float32 model keeps matrix products and convolutions in full
        float32 (TF32 off), so that it can be held against a float32 reference.
        """
        dev = resolve_device(device)
        use_full_float32()
        net = TacotronNetwork(self.hparams).to(dev)
        return net.train(is_training)


class DualSourceSelfAttentionTacotronModel(TacotronModelBase):
    """Self-Attention Tacotron: dual-source attention over the CBHG and SA streams."""

    def _validate(self):
        hp = self.hparams
        if "DualSource" not in hp.decoder:
            hp.decoder = "DualSourceSelfAttentionDecoder"
        if "SelfAttention" not in hp.encoder:
            raise ValueError(
                "DualSourceSelfAttentionTacotronModel requires a self-attention "
                f"encoder, got {hp.encoder!r}"
            )


_MODELS = {"DualSourceSelfAttentionTacotronModel": DualSourceSelfAttentionTacotronModel}
_NOT_PORTED = (
    "ExtendedTacotronV1Model",
    "MgcLf0TacotronModel",
    "DualSourceSelfAttentionMgcLf0TacotronModel",
)


def tacotron_model_factory(hparams: HParams) -> TacotronModelBase:
    """Factory keyed on ``hparams.tacotron_model``."""
    name = hparams.tacotron_model
    if name in _NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    try:
        cls = _MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown tacotron_model {name!r}; known: {sorted(_MODELS) + list(_NOT_PORTED)}"
        ) from None
    return cls(hparams)
