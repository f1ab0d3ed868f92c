"""Offline corpus preprocessing base: parallel utterance -> TFRecord pairs.

Counterpart of the JAX package's ``data/corpus.py``. A ``multiprocessing``
pool runs the per-utterance work (load -> trim -> STFT -> mel), which is
identical and embarrassingly parallel; each utterance emits
``<id>.source.tfrecord`` and ``<id>.target.tfrecord`` next to each other under
``out_dir``. The spectrograms are computed by :class:`Audio` on ``device``, the
card unless the caller asks for the CPU; the pool starts its workers by
``spawn``, since CUDA cannot be initialised in a forked child.
"""

from __future__ import annotations

import os
import multiprocessing
from typing import Iterable, List, Optional, Tuple

import numpy as np

from self_attention_tacotron_torch.audio import Audio
from self_attention_tacotron_torch.data.dataset import (
    SourceData,
    TargetData,
    write_source_tfrecord,
    write_target_tfrecord,
)
from self_attention_tacotron_torch.hparams import HParams


class CorpusPreprocessor:
    """Subclasses yield utterance descriptors and encode text; audio is shared."""

    def __init__(self, in_dir: str, out_dir: str, hparams: HParams, device="cuda"):
        self.in_dir = in_dir
        self.out_dir = out_dir
        self.hparams = hparams
        self.audio = Audio(hparams, device=device)
        os.makedirs(out_dir, exist_ok=True)

    # ------------------------ subclass interface ------------------------ #

    def list_utterances(self) -> List[dict]:
        """Return per-utterance descriptors: dicts with at least
        ``id``, ``wav_path``, ``text``; optionally ``speaker_id``,
        ``accent_type`` (list[int]) and ``phones`` (list[str])."""
        raise NotImplementedError

    def encode_text(self, utterance: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Return (source ids, accent type ids or None)."""
        raise NotImplementedError

    # --------------------------- preprocessing --------------------------- #

    def process_utterance(self, utterance: dict) -> Optional[str]:
        hp = self.hparams
        utt_id = utterance["id"]
        try:
            wav = self.audio.load_wav(utterance["wav_path"])
        except (ValueError, FileNotFoundError) as e:
            return f"{utt_id}: skipped ({e})"
        wav = self.audio.trim(wav)
        if wav.size < hp.hop_length * 2:
            return f"{utt_id}: skipped (too short after trim)"
        mel = self.audio.melspectrogram(wav)
        spec = (
            self.audio.spectrogram(wav)
            if hp.use_linear_spectrogram_postnet
            else None
        )
        source, accent = self.encode_text(utterance)
        write_source_tfrecord(
            os.path.join(self.out_dir, f"{utt_id}.{hp.source_file_extension}"),
            SourceData(
                id=utt_id,
                text=utterance["text"],
                source=source,
                source_length=len(source),
                speaker_id=int(utterance.get("speaker_id", 0)),
                accent_type=accent,
            ),
        )
        write_target_tfrecord(
            os.path.join(self.out_dir, f"{utt_id}.{hp.target_file_extension}"),
            TargetData(
                id=utt_id, target_length=mel.shape[0], mel=mel, spec=spec
            ),
        )
        return None

    def preprocess(self, num_workers: int = 1) -> List[str]:
        """Process the whole corpus; returns warnings for skipped utterances."""
        utterances = self.list_utterances()
        if num_workers <= 1:
            results = [self.process_utterance(u) for u in utterances]
        else:
            # spawned, not forked: CUDA cannot be initialised in a forked child, and
            # torch's CPU thread pool can hang in one
            with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
                results = pool.map(self.process_utterance, utterances)
        return [r for r in results if r]


def write_selected_lists(
    out_dir: str,
    ids: Iterable[str],
    *,
    validation_fraction: float = 0.05,
    test_fraction: float = 0.05,
    seed: int = 1234,
) -> None:
    """Deterministic train/validation/test id splits (``*.lst`` files)."""
    rng = np.random.RandomState(seed)
    ids = sorted(ids)
    perm = rng.permutation(len(ids))
    n_val = max(1, int(len(ids) * validation_fraction))
    n_test = max(1, int(len(ids) * test_fraction))
    splits = {
        "validation": [ids[i] for i in perm[:n_val]],
        "test": [ids[i] for i in perm[n_val : n_val + n_test]],
        "train": [ids[i] for i in perm[n_val + n_test :]],
    }
    os.makedirs(out_dir, exist_ok=True)
    for name, members in splits.items():
        with open(os.path.join(out_dir, f"{name}.lst"), "w") as f:
            f.write("\n".join(sorted(members)) + "\n")
