"""Top-level network, the model classes, and the model factory.

Counterpart of ``self_attention_tacotron_tpu/models/models.py``:
:class:`TacotronNetwork` holds embeddings, encoder and decoder, with the
teacher-forced ``forward`` of training and evaluation, and ``encode`` plus the
incremental decode plumbing that ``synthesis.py`` drives. The model classes bind
a network configuration to its loss: the baseline ``ExtendedTacotronV1Model``,
the flagship ``DualSourceSelfAttentionTacotronModel`` and their WORLD-feature
counterparts ``MgcLf0TacotronModel`` and
``DualSourceSelfAttentionMgcLf0TacotronModel`` (heads ``mgc`` and ``lf0``). The
postnets are not ported yet.

``hparams.compute_dtype`` ("float32" or "bfloat16") is every module's compute
dtype, flax's ``dtype`` of the JAX package (``_dtype_of``): the parameters stay
float32 (``convert.py`` loads them so), the activations take the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models import losses as losses_lib
from self_attention_tacotron_torch.models.attention import attention_factory
from self_attention_tacotron_torch.models.decoders import (
    Decoder,
    DecoderConditioning,
    decoder_factory,
)
from self_attention_tacotron_torch.models.encoders import encoder_factory, encoder_out_units
from self_attention_tacotron_torch.models.modules import (
    Embedding,
    sequence_mask,
    set_compute_dtype,
)
from self_attention_tacotron_torch.utils.platform import resolve_device, use_full_float32


@dataclasses.dataclass
class NetworkOutput:
    """Teacher-forced forward outputs (training and evaluation)."""

    frames: Dict[str, torch.Tensor]            # head -> (B, T, dim), before any postnet
    postnet_frames: Optional[torch.Tensor]     # refined mel, or None
    linear_frames: Optional[torch.Tensor]      # linear spectrogram, or None
    stop_logits: torch.Tensor                  # (B, T)
    alignments: Tuple[torch.Tensor, ...]       # per source (B, N_steps, S)
    encoder_sa_alignments: Tuple[torch.Tensor, ...]
    decoder_sa_alignments: Tuple[torch.Tensor, ...]


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(hparams: HParams) -> torch.dtype:
    """The torch dtype of ``hparams.compute_dtype``."""
    try:
        return COMPUTE_DTYPES[hparams.compute_dtype]
    except KeyError:
        raise ValueError(
            f"compute_dtype={hparams.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}"
        ) from None


class TacotronNetwork(nn.Module):
    """Embeddings + encoder + AR decoder, one module."""

    # the JAX package's parameter tree keeps the mechanisms at the top level
    flax_aliases = {"attention_0": "decoder.attention_0", "attention_1": "decoder.attention_1"}

    def __init__(self, hparams: HParams):
        super().__init__()
        hp = hparams
        self.hparams = hp
        dtype = compute_dtype_of(hp)
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
            memory_units = (encoder_out_units(hp),)
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
        set_compute_dtype(self, dtype)   # self.compute_dtype and every module's

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
        sa_aligns: Tuple[torch.Tensor, ...] = ()
        if isinstance(enc_out, tuple):
            memory1, memory2, sa_aligns = enc_out
            memories = (memory1, memory2) if self.dual_source else (memory1,)
        else:
            if self.dual_source:
                raise ValueError(
                    f"decoder {hp.decoder!r} needs a dual-stream encoder, got {hp.encoder!r}"
                )
            memories = (enc_out,)

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

    def forward(
        self,
        source: torch.Tensor,
        source_lengths: torch.Tensor,
        targets: torch.Tensor,           # (B, T, out_dim) padded to a multiple of r
        target_lengths: torch.Tensor,
        accent_type: Optional[torch.Tensor] = None,
        speaker_id: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> NetworkOutput:
        """Teacher-forced forward pass; every random draw comes from ``generator``."""
        cond, enc_sa = self.encode(source, source_lengths, accent_type, speaker_id, generator)
        frames, stop_logits, aligns, dec_sa = self.decoder(cond, targets, generator=generator)
        return NetworkOutput(
            frames=frames,
            postnet_frames=None,
            linear_frames=None,
            stop_logits=stop_logits,
            alignments=tuple(aligns),
            encoder_sa_alignments=tuple(enc_sa),
            decoder_sa_alignments=tuple(dec_sa),
        )

    # incremental decode plumbing, used by the synthesis loop

    def decoder_initial_state(self, cond: DecoderConditioning):
        return self.decoder.initial_state(cond)

    def decoder_init_caches(self, batch: int, max_len: int, device=None):
        return self.decoder.init_caches(batch, max_len, self.compute_dtype, device)

    def decoder_go_frame(self, batch: int, device=None):
        return self.decoder.go_frame(batch, self.compute_dtype, device)

    def decoder_step(self, state, feed, cond: DecoderConditioning, prenet_masks=None,
                     generator=None):
        return self.decoder.step(state, feed, cond, prenet_masks=prenet_masks,
                                 generator=generator)

    def decoder_post_step(self, feature, caches, index: int):
        return self.decoder.post_step(feature, caches, index)


class TacotronModelBase:
    """Binds a network configuration to its loss."""

    #: hparams overrides pinned by the named model class
    PINNED: Dict[str, Any] = {}
    #: target heads this model trains on
    HEADS: Tuple[str, ...] = ("mel",)

    def __init__(self, hparams: HParams):
        self.hparams = hparams
        for key, value in self.PINNED.items():
            setattr(hparams, key, value)
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

    def head_dims(self) -> Dict[str, int]:
        """Output head widths in the decoder's head order (the order of the fed-back block)."""
        hp = self.hparams
        dims = {"mel": hp.num_mels, "mgc": hp.num_mgcs, "lf0": hp.num_lf0s}
        return {h: dims[h] for h in self.HEADS}

    def loss(
        self,
        output: NetworkOutput,
        batch: Dict[str, torch.Tensor],
        params=None,
    ) -> Dict[str, torch.Tensor]:
        """Total loss and its parts. ``batch`` uses the data layer's field names;
        ``params`` (an iterable of parameters) is what L2 regularisation reads."""
        hp = self.hparams
        lengths = batch["target_lengths"]
        parts: Dict[str, torch.Tensor] = {}
        if "mel" in self.HEADS:
            parts["mel_loss"] = losses_lib.spec_loss(
                output.frames["mel"], batch["mel"], lengths, hp.spec_loss_type
            )
            if output.postnet_frames is not None:
                parts["postnet_loss"] = losses_lib.spec_loss(
                    output.postnet_frames, batch["mel"], lengths, hp.spec_loss_type
                )
            if output.linear_frames is not None and "spec" in batch:
                parts["linear_loss"] = losses_lib.spec_loss(
                    output.linear_frames, batch["spec"], lengths, hp.spec_loss_type
                )
            if hp.binary_divergence_weight > 0.0:
                parts["binary_divergence"] = (
                    hp.binary_divergence_weight
                    * losses_lib.binary_divergence(output.frames["mel"], batch["mel"], lengths)
                )
        if "mgc" in self.HEADS:
            parts["mgc_loss"] = losses_lib.spec_loss(
                output.frames["mgc"], batch["mgc"], lengths, hp.spec_loss_type
            )
            parts["lf0_loss"] = losses_lib.classification_loss(
                output.frames["lf0"], batch["lf0"], lengths
            )
        parts["done_loss"] = losses_lib.stop_token_loss(
            output.stop_logits, batch["done"], lengths
        )
        if hp.use_l2_regularization and params is not None:
            parts["l2_regularization"] = losses_lib.l2_regularization(
                params, hp.l2_regularization_weight
            )
        parts["loss"] = sum(parts.values())
        return parts


class ExtendedTacotronV1Model(TacotronModelBase):
    """Baseline Tacotron: single-source attention over EncoderV1 or ZoneoutEncoderV1, mel target."""

    PINNED = {"decoder": "ExtendedDecoder"}

    def _validate(self):
        if "SelfAttention" in self.hparams.encoder:
            raise ValueError(
                "ExtendedTacotronV1Model is single-source; use a single-stream encoder"
            )


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


class MgcLf0TacotronModel(TacotronModelBase):
    """WORLD-feature single-source model: mgc frames and quantised lf0 classes."""

    HEADS = ("mgc", "lf0")
    PINNED = {"decoder": "MgcLf0ExtendedDecoder"}


class DualSourceSelfAttentionMgcLf0TacotronModel(TacotronModelBase):
    """WORLD-feature dual-source self-attention model."""

    HEADS = ("mgc", "lf0")
    PINNED = {"decoder": "MgcLf0DualSourceSelfAttentionDecoder"}

    def _validate(self):
        if "SelfAttention" not in self.hparams.encoder:
            raise ValueError("requires a self-attention encoder")


_MODELS = {
    "ExtendedTacotronV1Model": ExtendedTacotronV1Model,
    "DualSourceSelfAttentionTacotronModel": DualSourceSelfAttentionTacotronModel,
    "MgcLf0TacotronModel": MgcLf0TacotronModel,
    "DualSourceSelfAttentionMgcLf0TacotronModel": DualSourceSelfAttentionMgcLf0TacotronModel,
}


def tacotron_model_factory(hparams: HParams) -> TacotronModelBase:
    """Factory keyed on ``hparams.tacotron_model``."""
    name = hparams.tacotron_model
    try:
        cls = _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown tacotron_model {name!r}; known: {sorted(_MODELS)}") from None
    return cls(hparams)
