"""Text frontends: English grapheme cleaners, Japanese phoneme + accent types."""

from self_attention_tacotron_torch.text.english import (
    sequence_to_text,
    text_to_sequence,
)
from self_attention_tacotron_torch.text.symbols import EOS_ID, PAD_ID, symbols

__all__ = ["text_to_sequence", "sequence_to_text", "symbols", "PAD_ID", "EOS_ID"]
