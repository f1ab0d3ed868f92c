"""Japanese phoneme + accentual-type frontend (pitch-accent language path).

The port's own copy of the JAX package's ``text/japanese.py``. Source records
carry a phoneme-id sequence plus an aligned accentual-type label sequence; the
corpus itself is not distributable, so this module provides the code path: a
phoneme inventory, accent-type encoding with the vocabulary offset convention
(``hparams.accent_type_offset``), and helpers to encode pre-aligned
(phoneme, accent) label files.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# Standard Japanese phoneme inventory (Julius/OpenJTalk-style romanization).
_PHONEMES = (
    "pad eos sil pau a i u e o N a: i: u: e: o: "
    "k ky g gy s sh z j t ts ty ch d dy n ny h hy f b by p py "
    "m my y r ry w v q cl"
).split()

phonemes = _PHONEMES
phoneme_to_id = {p: i for i, p in enumerate(_PHONEMES)}
id_to_phoneme = {i: p for i, p in enumerate(_PHONEMES)}

PAD_ID = 0
EOS_ID = 1


def phoneme_to_sequence(phoneme_labels: Sequence[str], append_eos: bool = True) -> List[int]:
    seq = [phoneme_to_id[p] for p in phoneme_labels if p in phoneme_to_id]
    if append_eos:
        seq.append(EOS_ID)
    return seq


def encode_accent_types(
    accent_labels: Sequence[int], offset: int, unknown: int, append_eos: bool = True
) -> List[int]:
    """Encode per-phoneme accentual-type labels with the vocab offset.

    Accent types are stored offset into a private codepoint range
    (``accent_type_offset``, default 0x3100) with a dedicated "unknown"
    label; the embedding layer subtracts the offset back out.
    """
    seq = [offset + int(a) for a in accent_labels]
    if append_eos:
        seq.append(unknown)
    return seq


def parse_label_file(path: str) -> List[Tuple[str, int]]:
    """Parse ``phoneme<TAB>accent_type`` lines into (phoneme, accent) pairs."""
    out: List[Tuple[str, int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((parts[0], int(parts[1]) if len(parts) > 1 else 0))
    return out
