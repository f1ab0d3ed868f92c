"""Flat weights in the JAX package's layout, into the reference and drawn from a seed.

The flat layout is the one ``scripts/convergence_run.py::export_params_npz``
writes and the program's ``convert.load_npz`` reads: ``params/a/b/kernel`` and
``batch_stats/a/b/mean|var`` keys, numpy arrays, a dense kernel (in, out), a
convolution's (taps, in, out). ``load_flat`` places such a dictionary in the
reference by its own names; ``leaf_table`` lists the leaves a configuration
has, with their flax shapes and initialisers, and ``draw_flat`` draws them from
a seed on the device, at the scale of flax's initialisers, in one call per kind.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from port_bench.reference.model import DenseIO, Embedding, HighwayNet, TacotronReference


def _resolve(root: nn.Module, names: Tuple[str, ...]) -> Tuple[nn.Module, str]:
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
    """(state name, array in torch layout) of one flax leaf, or None."""
    if collection == "batch_stats":
        if isinstance(module, nn.BatchNorm1d) and leaf in ("mean", "var"):
            return f"running_{leaf}", value
        return None
    if isinstance(module, nn.Linear):
        return {"kernel": ("weight", value.T), "bias": ("bias", value)}.get(leaf)
    if isinstance(module, nn.Conv1d):
        return {"kernel": ("weight", value.transpose(2, 1, 0)), "bias": ("bias", value)}.get(leaf)
    if isinstance(module, (nn.BatchNorm1d, nn.LayerNorm)):
        return {"scale": ("weight", value), "bias": ("bias", value)}.get(leaf)
    if isinstance(module, DenseIO) and leaf in ("kernel", "bias"):
        return leaf, value
    if isinstance(getattr(module, leaf, None), nn.Parameter):
        return leaf, value
    return None


def load_flat(net: TacotronReference, flat: Dict[str, np.ndarray]) -> TacotronReference:
    """Fill every parameter and batch-norm statistic of ``net`` from ``flat``; a
    key without a place, or an entry that no key fills, raises."""
    expected = {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
    state = {}
    for key, value in flat.items():
        collection, *names, leaf = key.split("/")
        target, path = _resolve(net, tuple(names))
        placed = _place(target, collection, leaf, np.asarray(value))
        if placed is None:
            raise KeyError(f"{key}: no place in the reference")
        name, array = placed
        full = f"{path}.{name}" if path else name
        if full not in expected or tuple(array.shape) != tuple(expected[full].shape):
            raise KeyError(f"{key}: does not fit {full}")
        state[full] = torch.as_tensor(np.ascontiguousarray(array), dtype=torch.float32)
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"no value for {missing[:8]}")
    device = next(net.parameters()).device
    net.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=False)
    return net


def _flax_names(root: nn.Module, parts: Tuple[str, ...]) -> Tuple[str, ...]:
    names, module = [], root
    while parts:
        step, name = 1, parts[0]
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


def leaf_table(hp: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(flax key, flax shape, initialiser, scale) of every leaf of ``hp``'s network.

    Initialisers (flax's): ``normal`` (scale: stddev; kernels take lecun's
    1 / sqrt(fan in), the embedding 0.5), ``uniform`` (scale: the limit; the
    attention vectors' glorot), ``const`` (scale: the value; biases 0, a highway's
    transform gate -1, norms' scales 1, running means 0 and variances 1)."""
    with torch.device("meta"):
        net = TacotronReference(hp)
    table = []
    entries = list(net.named_parameters()) + [
        (k, v) for k, v in net.named_buffers() if not k.endswith("num_batches_tracked")]
    for full, tensor in entries:
        *parts, leaf = full.split(".")
        owner = net.get_submodule(".".join(parts))
        names = _flax_names(net, tuple(parts))
        shape = tuple(tensor.shape)
        if isinstance(owner, nn.Linear):
            if leaf == "weight":
                row = ("kernel", shape[::-1], "normal", 1.0 / math.sqrt(shape[1]))
            else:
                parent = net.get_submodule(".".join(parts[:-1])) if len(parts) > 1 else None
                gate = isinstance(parent, HighwayNet) and parts[-1] == "T"
                row = ("bias", shape, "const", -1.0 if gate else 0.0)
        elif isinstance(owner, nn.Conv1d):
            row = ("kernel", (shape[2], shape[1], shape[0]), "normal",
                   1.0 / math.sqrt(shape[1] * shape[2]))
        elif isinstance(owner, nn.BatchNorm1d):
            row = {"weight": ("scale", shape, "const", 1.0), "bias": ("bias", shape, "const", 0.0),
                   "running_mean": ("mean", shape, "const", 0.0),
                   "running_var": ("var", shape, "const", 1.0)}[leaf]
        elif isinstance(owner, nn.LayerNorm):
            row = ("scale", shape, "const", 1.0) if leaf == "weight" else ("bias", shape, "const", 0.0)
        elif isinstance(owner, DenseIO):
            row = (("kernel", shape, "normal", 1.0 / math.sqrt(shape[0])) if leaf == "kernel"
                   else ("bias", shape, "const", 0.0))
        elif isinstance(owner, Embedding):
            row = ("embedding", shape, "normal", 0.5)
        elif leaf == "attention_v":
            row = ("attention_v", shape, "uniform", math.sqrt(6.0 / (shape[0] + shape[1])))
        else:
            raise KeyError(f"no initialiser for {full}")
        collection = "batch_stats" if leaf.startswith("running_") else "params"
        table.append(("/".join((collection, *names, row[0])), row[1], row[2], row[3]))
    return table


def draw_flat(hp: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Every leaf of ``hp``'s network drawn from ``seed`` on ``device``: one normal
    draw and one uniform draw for all leaves of their kind, in the order of
    ``leaf_table``, each leaf its slice times its scale; returned as float32
    numpy arrays in the flax layout."""
    table = leaf_table(hp)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    sizes = {kind: sum(int(np.prod(s)) for _, s, k, _ in table if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], device=device, generator=gen),
             "uniform": torch.rand(sizes["uniform"], device=device, generator=gen) * 2.0 - 1.0}
    offsets = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape, kind, scale in table:
        n = int(np.prod(shape))
        if kind == "const":
            out[key] = torch.full(shape, scale, device=device)
        else:
            out[key] = pools[kind][offsets[kind]: offsets[kind] + n].view(shape) * scale
            offsets[kind] += n
    host = torch.cat([v.reshape(-1) for v in out.values()]).cpu().numpy()
    flat, at = {}, 0
    for key, value in out.items():
        n = value.numel()
        flat[key] = host[at: at + n].reshape(tuple(value.shape))
        at += n
    return flat
