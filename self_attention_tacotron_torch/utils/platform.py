"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import os
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and there is none.

    There is no silent move to the CPU: a caller that wants the CPU says
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but no CUDA device is available; "
            'pass device="cpu" to run on the CPU'
        )
    return dev


def platform_device() -> torch.device:
    """The device of the command-line tools: the card, or the CPU where
    ``SATT_PLATFORM=cpu`` is set (the variable the JAX package's CLIs read). Under
    torchrun the card is ``cuda:LOCAL_RANK``.

    Without a card and without that variable this raises, as
    :func:`resolve_device` does for ``"cuda"``.
    """
    platform = os.environ.get("SATT_PLATFORM", "").lower()
    if platform not in ("", "cpu", "cuda", "gpu"):
        raise ValueError(f"SATT_PLATFORM={platform!r}: expected cpu, cuda or gpu")
    if platform == "cpu":
        return resolve_device("cpu")
    if "LOCAL_RANK" in os.environ:
        return resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return resolve_device("cuda")


def use_full_float32() -> None:
    """Keep float32 matrix products and convolutions in full float32.

    cuDNN convolutions default to TF32, which keeps about three decimal
    digits; the float32 model is held against a float32 reference, so both
    switches are turned off where a float32 model is built.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
