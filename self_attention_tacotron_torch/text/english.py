"""English text normalization and symbol-id encoding.

The port's own copy of the JAX package's ``text/english.py``: keithito-style
cleaners (lowercase, abbreviation expansion, number expansion, whitespace
collapse), then grapheme -> id mapping with EOS. Numbers are expanded with a
small self-contained spellout (no third-party inflect dependency).
"""

from __future__ import annotations

import re
from typing import List

from self_attention_tacotron_torch.text.symbols import EOS_ID, symbol_to_id, id_to_symbol

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

_WHITESPACE_RE = re.compile(r"\s+")
_NUMBER_RE = re.compile(r"\d+")

_ONES = "zero one two three four five six seven eight nine ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()


def _spell_under_thousand(n: int) -> str:
    parts: List[str] = []
    if n >= 100:
        parts.append(_ONES[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        word = _TENS[n // 10]
        if n % 10:
            word += " " + _ONES[n % 10]
        parts.append(word)
    elif n > 0 or not parts:
        parts.append(_ONES[n])
    return " ".join(parts)


def spell_number(n: int) -> str:
    if n == 0:
        return "zero"
    groups = ["", " thousand", " million", " billion"]
    parts: List[str] = []
    i = 0
    while n > 0 and i < len(groups):
        n, rem = divmod(n, 1000)
        if rem:
            parts.insert(0, _spell_under_thousand(rem) + groups[i])
        i += 1
    return " ".join(parts)


def expand_numbers(text: str) -> str:
    return _NUMBER_RE.sub(lambda m: spell_number(int(m.group(0))), text)


def expand_abbreviations(text: str) -> str:
    for pattern, replacement in _ABBREVIATIONS:
        text = pattern.sub(replacement, text)
    return text


def english_cleaners(text: str) -> str:
    text = text.lower()
    text = expand_abbreviations(text)
    text = expand_numbers(text)
    text = _WHITESPACE_RE.sub(" ", text).strip()
    return text


def text_to_sequence(text: str, append_eos: bool = True) -> List[int]:
    """Normalize and encode to symbol ids; unknown characters are dropped."""
    cleaned = english_cleaners(text)
    seq = [symbol_to_id[c] for c in cleaned if c in symbol_to_id]
    if append_eos:
        seq.append(EOS_ID)
    return seq


def sequence_to_text(sequence) -> str:
    return "".join(id_to_symbol[int(i)] for i in sequence if int(i) in id_to_symbol)
