"""Synthetic corpus generator: tests, smoke training, and benchmarks.

Counterpart of the JAX package's ``data/synthetic.py``: the same
``np.random.RandomState`` stream, so for the same seed and hparams the port
writes the same ids, texts, sources and lists as the JAX package, and mels
from the same wavs (computed by the port's :class:`Audio` on ``device``).
Deterministic sine-mixture "speech" whose mel content follows the "text", so
a small model can actually learn alignments and the whole path
(preprocess -> train -> synthesize) runs without downloading data.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from self_attention_tacotron_torch.data.corpus import CorpusPreprocessor, write_selected_lists
from self_attention_tacotron_torch.data.dataset import (
    SourceData,
    TargetData,
    write_source_tfrecord,
    write_target_tfrecord,
)
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.text import text_to_sequence


SEG_SECONDS = 0.08  # per-symbol tone-segment duration


def _symbol_freq(sym: int, speaker: int = 0, accent_high: bool = False) -> float:
    """Fundamental of one symbol's tone segment.

    The conditioning signals are REAL, learnable acoustic effects:
    * ``speaker``: each speaker speaks in a distinct register (×1.35 per
      speaker index) — so a multi-speaker model must route the speaker
      embedding into the decoder to predict the right spectra, and
      speaker-swap at synthesis measurably shifts the spectral centroid.
    * ``accent_high``: a high pitch accent doubles the fundamental
      (mirroring the Japanese high/low pitch-accent distinction the
      ICASSP'19 reference conditions on) — an accent-conditioned model
      must consume the accent ids to place the octave correctly.
    """
    freq = 110.0 * (1.0 + (int(sym) % 24) / 4.0)
    # clamp the register so the realizable range provably stays within the
    # lf0 quantization bounds [fmin, fmax] of _world_features:
    # base ceiling 742.5 Hz × 1.35^3 × 2 (accent) ≈ 3.65 kHz < 3.7 kHz;
    # 1.35^4 would exceed fmax AND approach Nyquist at 16 kHz.
    freq *= 1.35 ** min(int(speaker), 3)
    if accent_high:
        freq *= 2.0
    return freq


def _synthetic_wav(
    rng: np.random.RandomState,
    text_ids: np.ndarray,
    hp: HParams,
    *,
    speaker: int = 0,
    accent: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-symbol tone segments — alignment between text and audio is real."""
    seg = int(SEG_SECONDS * hp.sample_rate)
    t = np.arange(seg) / hp.sample_rate
    chunks = []
    for j, sym in enumerate(text_ids):
        high = accent is not None and _accent_is_high(hp, int(accent[j]))
        freq = _symbol_freq(int(sym), speaker, high)
        env = np.hanning(seg)
        chunks.append(np.sin(2 * np.pi * freq * t) * env * 0.5)
    return np.concatenate(chunks).astype(np.float32)


def _accent_is_high(hp: HParams, accent_id: int) -> bool:
    """Odd accent types are 'high' — a fixed, learnable convention."""
    return (accent_id - hp.accent_type_offset) % 2 == 1


def _world_features(
    mel: np.ndarray,
    text_ids: np.ndarray,
    hp: HParams,
    *,
    speaker: int = 0,
    accent: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable WORLD-feature stand-ins derived from the actual audio.

    mgc: a fixed linear down-projection of the mel (stride-sampled bands)
    — the mgc MSE head can actually fit it. lf0: the active symbol's
    frequency quantized into ``num_lf0s`` bins per frame — the lf0
    classification head has a real frame-to-pitch mapping to learn.
    """
    n_frames = mel.shape[0]
    if hp.num_mgcs > mel.shape[1]:
        raise ValueError(
            f"num_mgcs={hp.num_mgcs} exceeds num_mels={mel.shape[1]}: the "
            "synthetic mgc is a strided down-projection of the mel, so it "
            "cannot be wider — lower hparams.num_mgcs or raise num_mels"
        )
    stride = max(mel.shape[1] // hp.num_mgcs, 1)
    mgc = mel[:, : stride * hp.num_mgcs : stride].astype(np.float32)
    frames_per_symbol = SEG_SECONDS * 1000.0 / hp.frame_shift_ms
    sym_idx = np.minimum(
        (np.arange(n_frames) / frames_per_symbol).astype(np.int64),
        len(text_ids) - 1,
    )
    # MUST mirror _synthetic_wav's per-symbol frequency exactly — the lf0
    # labels describe the audio, so speaker register and accent doubling
    # apply here too (they previously defaulted to speaker 0 / no accent,
    # mislabeling multi-speaker or accented MgcLf0 corpora).
    freqs = np.asarray(
        [
            _symbol_freq(
                int(s),
                speaker,
                accent is not None and _accent_is_high(hp, int(accent[j])),
            )
            for j, s in enumerate(text_ids)
        ],
        np.float64,
    )
    # log-quantization bounds cover the full realizable range: base
    # 110–742.5 Hz × 1.35^speaker (≤3 with the 4-speaker recipes) × 2
    # accent doubling ≈ 3.65 kHz ceiling
    fmin, fmax = 100.0, 3700.0
    rel = (np.log(freqs[sym_idx]) - np.log(fmin)) / (np.log(fmax) - np.log(fmin))
    lf0 = np.clip(
        (rel * (hp.num_lf0s - 1)).round(), 0, hp.num_lf0s - 1
    ).astype(np.int64)
    return mgc, lf0


def generate_corpus(
    out_dir: str,
    hparams: HParams,
    *,
    num_utterances: int = 32,
    min_symbols: int = 8,
    max_symbols: int = 24,
    num_speakers: int = 1,
    with_accent: bool = False,
    selected_list_dir: Optional[str] = None,
    seed: int = 1234,
    device="cuda",
) -> List[str]:
    """Write a synthetic TFRecord corpus; returns the utterance ids. The
    spectrograms are computed on ``device``, the card unless told ``"cpu"``."""
    if num_speakers > 4:
        raise ValueError(
            f"num_speakers={num_speakers}: the synthetic register scale "
            "1.35**speaker only stays within the lf0 quantization ceiling "
            "(and comfortably below Nyquist) for speakers 0-3"
        )
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    from self_attention_tacotron_torch.audio import Audio

    audio = Audio(hparams, device=device)
    alphabet = "abcdefghijklmnopqrstuvwxyz "
    ids = []
    for i in range(num_utterances):
        utt_id = f"synth-{i:04d}"
        n = rng.randint(min_symbols, max_symbols + 1)
        text = "".join(alphabet[rng.randint(len(alphabet))] for _ in range(n))
        source = np.asarray(text_to_sequence(text), np.int64)
        accent = None
        if with_accent:
            accent = hparams.accent_type_offset + rng.randint(
                0, max(hparams.num_accent_type - 1, 1), size=len(source)
            ).astype(np.int64)
        # round-robin keeps speakers balanced; the speaker SHAPES the audio
        # (register), so the embedding is learnable, not decorative
        speaker = i % num_speakers
        wav = _synthetic_wav(rng, source, hparams, speaker=speaker, accent=accent)
        mel = audio.melspectrogram(wav)
        spec = (
            audio.spectrogram(wav) if hparams.use_linear_spectrogram_postnet else None
        )
        write_source_tfrecord(
            os.path.join(out_dir, f"{utt_id}.{hparams.source_file_extension}"),
            SourceData(
                id=utt_id,
                text=text,
                source=source,
                source_length=len(source),
                speaker_id=speaker,
                accent_type=accent,
            ),
        )
        mgc = lf0 = None
        if "MgcLf0" in hparams.tacotron_model or "MgcLf0" in hparams.decoder:
            mgc, lf0 = _world_features(
                mel, source, hparams, speaker=speaker, accent=accent
            )
        write_target_tfrecord(
            os.path.join(out_dir, f"{utt_id}.{hparams.target_file_extension}"),
            TargetData(
                id=utt_id, target_length=mel.shape[0], mel=mel, spec=spec,
                mgc=mgc, lf0=lf0,
            ),
        )
        ids.append(utt_id)
    if selected_list_dir:
        write_selected_lists(selected_list_dir, ids)
    return ids


class SyntheticCorpus(CorpusPreprocessor):
    """Preprocessor-shaped wrapper so the factory/CLI can target 'synthetic'."""

    def list_utterances(self) -> List[dict]:
        return [dict(id=f"synth-{i:04d}", num=i) for i in range(32)]

    def encode_text(self, utterance: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        raise NotImplementedError("SyntheticCorpus generates directly")

    def preprocess(self, num_workers: int = 1) -> List[str]:
        generate_corpus(self.out_dir, self.hparams, device=self.audio.device)
        return []
