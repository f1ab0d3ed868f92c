"""Batched synthesis: encode, then the autoregressive decode of the output heads.

Counterpart of ``self_attention_tacotron_tpu/synthesis.py`` (``make_predict_fn``):
encode the whole source in parallel, decode with per-lane stop tokens, and
return the same output dictionary. The decode is the whole-loop kernel of
``ops/fused_decode.py`` where the configuration has one, else the step-by-step
loop of ``ops/decode_loop.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from self_attention_tacotron_torch.models.models import TacotronNetwork
from self_attention_tacotron_torch.ops.decode_loop import DecodeResult, decode_incrementally
from self_attention_tacotron_torch.ops.fused_decode import (
    fused_decode,
    pack_decoder,
    supports_fused_decode,
)
from self_attention_tacotron_torch.utils.platform import resolve_device, use_full_float32


def make_predict_fn(
    model: TacotronNetwork,
    max_iters: Optional[int] = None,
    device="cuda",
    early_exit: bool = True,
    use_fused: Optional[bool] = None,
):
    """Build ``predict(batch, generator=None, prenet_masks=None) -> dict``.

    ``model`` is a :class:`TacotronNetwork` with its weights inside (see
    ``convert.load_npz``); it is moved to ``device`` and put in eval mode.
    ``device`` defaults to the card and raises if there is none; only
    ``device="cpu"`` runs on the CPU.

    ``batch`` fields (tensors or numpy arrays): ``source`` (B, S) integer ids,
    ``source_lengths`` (B,), optional ``accent_type`` (B, S), ``speaker_id`` (B,).

    ``generator``: the ``torch.Generator`` (on ``device``) that the encoder's and
    the decoder's prenet dropout draw from; prenet dropout stays on at inference.
    ``prenet_masks``: optional decoder prenet keep-masks, one
    (max_iters, B, units) boolean array per prenet layer, used instead of drawing.

    ``early_exit=False`` runs every request to ``max_iters`` and so spares the
    step-by-step loop its one host synchronisation per step (see
    ``ops/decode_loop.py``).

    ``use_fused``: decode with the whole-loop kernel of ``ops/fused_decode.py``.
    Default: on where ``hparams.use_pallas_kernels`` is set, the configuration is
    one the kernel serves (``supports_fused_decode``, float32 and bfloat16 alike)
    and the device is the card; else the step-by-step loop. ``True`` raises for a configuration the kernel does
    not serve, and with ``device="cpu"`` runs the kernel's plain version. On the
    card the fused decode launches its kernel or raises (``RuntimeError`` where
    ``max_iters`` or the source is so long that one block outgrows an SM's shared
    memory): nothing gives way to the loop, which a caller asks for with
    ``use_fused=False``. The weights are packed for the kernel here, once, so load
    them before this call. Both decodes take the same masks, drawn before the
    choice, so they consume the generator alike.

    The output dictionary has one entry per output head, ``mel`` (B, max_iters*r,
    num_mels) or, for the ``MgcLf0`` decoders, ``mgc`` (B, max_iters*r, num_mgcs) and
    ``lf0`` (B, max_iters*r, num_lf0s) class logits; then ``stop_probs``
    (B, max_iters*r), ``lengths`` (B,), ``alignments`` (per source, (B, max_iters,
    S)), ``encoder_sa_alignments`` (per block, (B, H, S, S); empty for a
    single-stream encoder), ``finished`` (B,) and
    ``num_steps`` (), all tensors on ``device``; the floats are float32 whatever
    ``hparams.compute_dtype``, as the JAX package returns them.
    """
    dev = resolve_device(device)
    use_full_float32()
    net = model.to(dev).eval()
    hp = net.hparams
    if hp.use_postnet_v2 or hp.use_linear_spectrogram_postnet:
        raise NotImplementedError("the postnets are not ported yet")
    max_steps = int(max_iters or hp.max_iters)
    r = hp.outputs_per_step
    head_dims = dict(net.decoder.output_heads)
    if use_fused is None:
        use_fused = hp.use_pallas_kernels and supports_fused_decode(hp) and dev.type == "cuda"
    elif use_fused and not supports_fused_decode(hp):
        raise ValueError("configuration not supported by the fused decode kernel")
    packed = pack_decoder(net.decoder) if use_fused else None

    def to_device(value, dtype=None):
        if value is None:
            return None
        return torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value).to(
            device=dev, dtype=dtype
        )

    @torch.inference_mode()
    def predict(
        batch: Dict[str, object],
        generator: Optional[torch.Generator] = None,
        prenet_masks: Optional[Sequence[object]] = None,
    ) -> Dict[str, object]:
        if "target_lengths" in batch:
            raise NotImplementedError("forced-alignment mode is not ported yet")
        source = to_device(batch["source"], torch.long)
        src_len = to_device(batch["source_lengths"], torch.long)
        batch_size = source.shape[0]

        cond, enc_sa = net.encode(
            source,
            src_len,
            to_device(batch.get("accent_type"), torch.long),
            to_device(batch.get("speaker_id"), torch.long),
            generator=generator,
        )

        # every step's prenet dropout masks in one draw
        if prenet_masks is not None:
            masks = tuple(to_device(m, torch.bool) for m in prenet_masks)
        elif hp.decoder_prenet_drop_rate > 0.0:
            keep = 1.0 - hp.decoder_prenet_drop_rate
            masks = tuple(
                torch.rand(max_steps, batch_size, units, device=dev, generator=generator) < keep
                for units in hp.decoder_prenet_out_units
            )
        else:
            masks = None

        if use_fused:
            result = fused_decode(
                packed, cond, masks, max_steps, hp.stop_token_threshold, early_exit=early_exit
            )
            return _assemble_outputs(result, enc_sa)

        def step_fn(state, feed, t):
            step_masks = None if masks is None else tuple(m[t] for m in masks)
            new_state, (feature, aligns) = net.decoder_step(state, feed, cond, step_masks)
            return new_state, feature, aligns

        result: DecodeResult = decode_incrementally(
            step_fn=step_fn,
            post_step_fn=net.decoder_post_step,
            init_state=net.decoder_initial_state(cond),
            init_caches=net.decoder_init_caches(batch_size, max_steps, dev),
            go_frame=net.decoder_go_frame(batch_size, dev),
            src_shapes=tuple(m.shape[1] for m in cond.memories),
            head_dims=head_dims,
            batch=batch_size,
            max_iters=max_steps,
            outputs_per_step=r,
            n_feed_frame=hp.n_feed_frame,
            stop_threshold=hp.stop_token_threshold,
            early_exit=early_exit,
        )
        return _assemble_outputs(result, enc_sa)

    return predict


def _assemble_outputs(result: DecodeResult, enc_sa) -> Dict[str, object]:
    out = {
        "lengths": result.lengths,
        "stop_probs": result.stop_probs,
        "alignments": result.alignments,
        "encoder_sa_alignments": enc_sa,
        "finished": result.finished,
        "num_steps": result.num_steps,
    }
    out.update(result.frames)
    return out
