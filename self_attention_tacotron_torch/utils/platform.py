"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

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


def use_full_float32() -> None:
    """Keep float32 matrix products and convolutions in full float32.

    cuDNN convolutions default to TF32, which keeps about three decimal
    digits; the float32 model is held against a float32 reference, so both
    switches are turned off where a float32 model is built.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
