"""LJSpeech recipe: metadata.csv -> per-utterance TFRecord pairs.

The port's own copy of the JAX package's ``data/ljspeech.py``. Single speaker,
English graphemes via keithito-style cleaners.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from self_attention_tacotron_torch.data.corpus import CorpusPreprocessor
from self_attention_tacotron_torch.text import text_to_sequence


class LJSpeech(CorpusPreprocessor):
    """Expects the standard layout: ``metadata.csv`` + ``wavs/<id>.wav``."""

    def list_utterances(self) -> List[dict]:
        path = os.path.join(self.in_dir, "metadata.csv")
        utterances = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) < 2:
                    continue
                utt_id = parts[0]
                text = parts[2] if len(parts) > 2 and parts[2] else parts[1]
                utterances.append(
                    dict(
                        id=utt_id,
                        wav_path=os.path.join(self.in_dir, "wavs", f"{utt_id}.wav"),
                        text=text,
                        speaker_id=0,
                    )
                )
        return utterances

    def encode_text(self, utterance: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return np.asarray(text_to_sequence(utterance["text"]), np.int64), None
