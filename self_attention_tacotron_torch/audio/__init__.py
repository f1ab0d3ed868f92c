"""Audio frontend: torch DSP and the ``Audio`` facade."""

from self_attention_tacotron_torch.audio.audio import Audio
from self_attention_tacotron_torch.audio import dsp

__all__ = ["Audio", "dsp"]
