"""Self-Attention Tacotron in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX package ``self_attention_tacotron_tpu`` that lives beside it:
same module layout, same public array layouts, same hyper-parameters. It
imports ``torch`` and numpy only. Entry points run on a CUDA device unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from self_attention_tacotron_torch.hparams import HParams, default_hparams

__all__ = ["HParams", "default_hparams", "__version__"]
