"""Japanese pitch-accent recipe: phoneme + accentual-type label corpus.

The port's own copy of the JAX package's ``data/japanese.py``. The corpus is
not distributable, so this recipe is a code path for corpora prepared as
pre-aligned label files. Expected layout::

    <in_dir>/wav/<id>.wav
    <in_dir>/labels/<id>.lab     # lines: "<phoneme> <accent_type_int>"
    <in_dir>/transcript.txt      # optional "<id>|<text>" display text

Accent types are stored with the vocabulary-offset convention
(``hparams.accent_type_offset``; unknown = ``hparams.accent_type_unknown``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from self_attention_tacotron_torch.data.corpus import CorpusPreprocessor
from self_attention_tacotron_torch.text import japanese as ja


class JapanesePitchAccent(CorpusPreprocessor):
    def list_utterances(self) -> List[dict]:
        label_dir = os.path.join(self.in_dir, "labels")
        texts = {}
        transcript = os.path.join(self.in_dir, "transcript.txt")
        if os.path.exists(transcript):
            with open(transcript, encoding="utf-8") as f:
                for line in f:
                    if "|" in line:
                        utt_id, text = line.strip().split("|", 1)
                        texts[utt_id] = text
        utterances = []
        for fname in sorted(os.listdir(label_dir)):
            if not fname.endswith(".lab"):
                continue
            utt_id = fname[: -len(".lab")]
            utterances.append(
                dict(
                    id=utt_id,
                    wav_path=os.path.join(self.in_dir, "wav", f"{utt_id}.wav"),
                    label_path=os.path.join(label_dir, fname),
                    text=texts.get(utt_id, utt_id),
                    speaker_id=0,
                )
            )
        return utterances

    def encode_text(self, utterance: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        hp = self.hparams
        pairs = ja.parse_label_file(utterance["label_path"])
        phones = [p for p, _ in pairs]
        accents = [a for _, a in pairs]
        source = np.asarray(ja.phoneme_to_sequence(phones), np.int64)
        accent = np.asarray(
            ja.encode_accent_types(
                accents, hp.accent_type_offset, hp.accent_type_unknown
            ),
            np.int64,
        )
        return source, accent
