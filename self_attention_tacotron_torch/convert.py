"""Weights of the JAX package into the port's modules.

Input is the flat layout that ``scripts/convergence_run.py::export_params_npz``
writes: ``params/a/b/kernel`` and ``batch_stats/a/b/mean|var`` keys, numpy
arrays. The port's sub-modules carry the names of the JAX parameter tree, so a
key is placed by walking those names (plus each module's ``flax_aliases``) and
laid out by the type of the module it lands in:

* Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
* Conv ``kernel`` (K, in, out) -> ``nn.Conv1d.weight`` (out, in, K);
* BatchNorm ``scale/bias`` and ``batch_stats mean/var`` ->
  ``weight/bias/running_mean/running_var``; LayerNorm ``scale`` -> ``weight``;
* LSTM ``gates`` is one Linear whose output stays packed i, g, f, o;
* GRU ``gates``/``candidate`` kernels keep their (C + H, .) layout, rows ``[x | h]``;
* a parameter held directly by a module (``embedding``, ``attention_v``) is copied.

A key that finds no place raises, and so does a parameter or buffer of the
module that no key filled.

``torch_to_flax_flat`` is the way back: a module's parameters and batch-norm
statistics, or its gradients, in the same flat layout, so that a test can hold
gradients and updated weights against the JAX package leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import TacotronNetwork
from self_attention_tacotron_torch.models.modules import DenseIO
from self_attention_tacotron_torch.utils.platform import resolve_device, use_full_float32

# buffers that carry no trained value
_IGNORED_BUFFERS = ("num_batches_tracked",)


def _resolve(root: nn.Module, names: Tuple[str, ...]) -> Tuple[nn.Module, str]:
    """Walk ``names`` down from ``root``; return the module reached and its dotted path."""
    module, path = root, []
    for name in names:
        alias = getattr(module, "flax_aliases", {}).get(name, name)
        for part in alias.split("."):
            child = getattr(module, part, None)
            if not isinstance(child, nn.Module):
                raise KeyError(part)
            module = child
            path.append(part)
    return module, ".".join(path)


def _place(module: nn.Module, collection: str, leaf: str, value: np.ndarray):
    """(state-dict leaf name, array in torch layout) for one flax leaf."""
    if collection == "batch_stats":
        if isinstance(module, nn.BatchNorm1d) and leaf in ("mean", "var"):
            return f"running_{leaf}", value
        return None
    if isinstance(module, nn.Linear):
        if leaf == "kernel":
            return "weight", value.T
        if leaf == "bias":
            return "bias", value
    elif isinstance(module, nn.Conv1d):
        if leaf == "kernel":
            return "weight", value.transpose(2, 1, 0)
        if leaf == "bias":
            return "bias", value
    elif isinstance(module, (nn.BatchNorm1d, nn.LayerNorm)):
        if leaf == "scale":
            return "weight", value
        if leaf == "bias":
            return "bias", value
    elif isinstance(module, DenseIO):
        if leaf in ("kernel", "bias"):
            return leaf, value
    elif isinstance(getattr(module, leaf, None), nn.Parameter):
        return leaf, value
    return None


def flax_to_torch_state(
    flat: Dict[str, np.ndarray], hp: Optional[HParams], module: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``module`` from flat flax variables.

    ``module`` defaults to a :class:`TacotronNetwork` built from ``hp``; a test
    of one module passes that module and the variables of its flax twin.
    """
    if module is None:
        module = TacotronNetwork(hp)
    expected = {
        k: v for k, v in module.state_dict().items() if not k.endswith(_IGNORED_BUFFERS)
    }
    state: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        collection, *names, leaf = key.split("/")
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"{key}: unknown collection {collection!r}")
        try:
            target, path = _resolve(module, tuple(names))
        except KeyError as missing:
            raise KeyError(f"{key}: the module has no sub-module {missing}") from None
        placed = _place(target, collection, leaf, np.asarray(value))
        if placed is None:
            raise KeyError(f"{key}: no place for leaf {leaf!r} in {type(target).__name__}")
        name, array = placed
        full = f"{path}.{name}" if path else name
        if full not in expected:
            raise KeyError(f"{key}: {full} is not in the module's state")
        if tuple(array.shape) != tuple(expected[full].shape):
            raise ValueError(
                f"{key}: shape {tuple(array.shape)} does not fit {full} "
                f"{tuple(expected[full].shape)}"
            )
        if full in state:
            raise KeyError(f"{key}: {full} was filled twice")
        state[full] = torch.tensor(np.ascontiguousarray(array), dtype=expected[full].dtype)
    unfilled = sorted(set(expected) - set(state))
    if unfilled:
        raise KeyError(f"no value for {len(unfilled)} entries of the module: {unfilled[:8]}")
    return state


def _flax_names(root: nn.Module, parts: Tuple[str, ...]) -> Tuple[str, ...]:
    """The JAX parameter tree's names for the sub-module at ``parts`` below ``root``."""
    names, module = [], root
    while parts:
        step = 1
        name = parts[0]
        for flax_name, dotted in getattr(module, "flax_aliases", {}).items():
            alias = tuple(dotted.split("."))
            if parts[: len(alias)] == alias:
                name, step = flax_name, len(alias)
                break
        for part in parts[:step]:
            module = getattr(module, part)
        names.append(name)
        parts = parts[step:]
    return tuple(names)


def _place_back(module: nn.Module, leaf: str, value: np.ndarray):
    """(collection, flax leaf name, array in flax layout) for one state-dict leaf."""
    if isinstance(module, nn.Linear):
        return ("params", "kernel", value.T) if leaf == "weight" else ("params", "bias", value)
    if isinstance(module, nn.Conv1d):
        if leaf == "weight":
            return "params", "kernel", value.transpose(2, 1, 0)
        return "params", "bias", value
    if isinstance(module, nn.BatchNorm1d) and leaf.startswith("running_"):
        return "batch_stats", leaf[len("running_"):], value
    if isinstance(module, (nn.BatchNorm1d, nn.LayerNorm)):
        return "params", "scale" if leaf == "weight" else "bias", value
    return "params", leaf, value


def torch_to_flax_flat(module: nn.Module, gradients: bool = False) -> Dict[str, np.ndarray]:
    """The inverse of ``flax_to_torch_state``: ``params/...`` and ``batch_stats/...``
    keys with numpy leaves in the JAX package's layouts.

    ``gradients=True`` gives the parameters' ``.grad`` under the ``params/...``
    keys instead (a parameter without a gradient gives zeros) and no batch
    statistics. The arrays are copies and do not follow later updates.
    """
    flat: Dict[str, np.ndarray] = {}
    entries = list(module.named_parameters())
    if not gradients:
        entries += [(k, v) for k, v in module.named_buffers() if not k.endswith(_IGNORED_BUFFERS)]
    for full, tensor in entries:
        *parts, leaf = full.split(".")
        owner = module.get_submodule(".".join(parts))
        if gradients:
            tensor = torch.zeros_like(tensor) if tensor.grad is None else tensor.grad
        collection, name, array = _place_back(owner, leaf, tensor.detach().cpu().numpy())
        key = "/".join((collection, *_flax_names(module, tuple(parts)), name))
        flat[key] = np.array(array)     # a copy: the tensor's memory changes with the next update
    return flat


def load_state(module: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a converted state into ``module`` (batch-norm step counters keep their value)."""
    result = module.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith(_IGNORED_BUFFERS)]
    if missing or result.unexpected_keys:
        raise KeyError(f"missing {missing}, unexpected {result.unexpected_keys}")
    return module


def load_npz(path: str, hp: HParams, device="cuda") -> TacotronNetwork:
    """The network of ``hp`` with the weights of a flat npz, on ``device``, in eval mode.

    ``device`` defaults to the card and raises if there is none.
    """
    dev = resolve_device(device)
    use_full_float32()
    with np.load(path) as archive:
        flat = {k: archive[k] for k in archive.files}
    net = TacotronNetwork(hp)
    load_state(net, flax_to_torch_state(flat, hp, net))
    return net.to(dev).eval()
