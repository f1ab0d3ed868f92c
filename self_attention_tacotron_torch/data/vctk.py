"""VCTK recipe: multi-speaker corpus -> TFRecord pairs with speaker ids.

The port's own copy of the JAX package's ``data/vctk.py``. Speaker ids are
assigned by sorted speaker directory order (stable across runs);
train/validation/test splits are written with
:func:`...data.corpus.write_selected_lists`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from self_attention_tacotron_torch.data.corpus import CorpusPreprocessor
from self_attention_tacotron_torch.text import text_to_sequence


class VCTK(CorpusPreprocessor):
    """Expects ``wav48/<speaker>/<utt>.wav`` + ``txt/<speaker>/<utt>.txt``."""

    def __init__(self, in_dir: str, out_dir: str, hparams, device="cuda"):
        super().__init__(in_dir, out_dir, hparams, device=device)
        self._speaker_ids: Dict[str, int] = {}

    @property
    def speaker_ids(self) -> Dict[str, int]:
        if not self._speaker_ids:
            wav_root = self._wav_root()
            speakers = sorted(
                d for d in os.listdir(wav_root)
                if os.path.isdir(os.path.join(wav_root, d))
            )
            self._speaker_ids = {s: i for i, s in enumerate(speakers)}
        return self._speaker_ids

    def _wav_root(self) -> str:
        for name in ("wav48", "wav48_silence_trimmed", "wavs"):
            path = os.path.join(self.in_dir, name)
            if os.path.isdir(path):
                return path
        raise FileNotFoundError(f"no wav directory under {self.in_dir}")

    def list_utterances(self) -> List[dict]:
        wav_root = self._wav_root()
        txt_root = os.path.join(self.in_dir, "txt")
        utterances = []
        for speaker, speaker_id in self.speaker_ids.items():
            spk_wav = os.path.join(wav_root, speaker)
            for fname in sorted(os.listdir(spk_wav)):
                if not fname.endswith(".wav"):
                    continue
                utt_id = fname[: -len(".wav")]
                txt_path = os.path.join(txt_root, speaker, f"{utt_id}.txt")
                if not os.path.exists(txt_path):
                    continue
                with open(txt_path, encoding="utf-8") as f:
                    text = f.read().strip()
                utterances.append(
                    dict(
                        id=utt_id,
                        wav_path=os.path.join(spk_wav, fname),
                        text=text,
                        speaker_id=speaker_id,
                    )
                )
        return utterances

    def encode_text(self, utterance: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return np.asarray(text_to_sequence(utterance["text"]), np.int64), None
