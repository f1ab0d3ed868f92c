"""The reference of the dual-source Self-Attention Tacotron configurations, as the
check and the harness take it.

A configuration names its reference under ``"reference"``; ``check.reference``
loads ``reference/<name>.py``. Such a module gives five names: ``network(hp,
flat, device)`` (the reference network with the flat weights in it),
``draw_flat(hp, seed, device)`` (seeded weights in the flat layout),
``set_operand_rounding(net, fn)``, ``make_adam(hp, params)`` and
``train_step(net, adam, hp, step, batch, generator)``. A family of another
structure brings a module of its own with these names, and configurations that
name it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from port_bench.reference.model import (TacotronReference, make_adam,  # noqa: F401
                                        set_operand_rounding, train_step)
from port_bench.reference.weights import draw_flat, load_flat  # noqa: F401


def network(hp: Dict, flat: Dict[str, np.ndarray], device) -> TacotronReference:
    with torch.device("meta"):
        net = TacotronReference(hp)
    return load_flat(net.to_empty(device=device), flat)
