"""The port's device mesh: data-parallel ranks and the model axis's placements.

Counterpart of ``self_attention_tacotron_tpu/parallel/mesh.py``. There a
``jax.sharding.Mesh`` with a ``data`` axis and a ``model`` axis lets GSPMD insert
the collectives; here the mesh is the ranks of ``torch.distributed``'s default
process group laid out as (data, model) on a ``DeviceMesh``, rank ``d * model + m``
at coordinate (d, m), as JAX reshapes its devices, and the collectives are
``torch.distributed``'s, called where one device would take the whole batch
(``parallel/shard.py``). No collective is written by hand.

* ``make_mesh``: every rank on ``data`` by default; a shape whose product is not
  the world size raises JAX's ``ValueError``. A mesh of one rank needs no process
  group and runs no collective.
* ``shard_batch``: this rank's rows of a global batch, padded and warned about by
  JAX's rules.
* ``param_sharding_rules`` / ``shard_params``: JAX's five tensor-parallel rules on
  the flax path of each parameter (``convert.flax_layout``). A placed parameter
  keeps only its slice on each rank of a ``model`` group and is gathered whole
  before each use (a parametrization); the gather's backward takes the rank's
  slice of the gradient, which every rank of the group computed whole. This is
  JAX's placement (the memory of those leaves divided by ``model``), not a split
  of the compute, which the JAX package does not promise either.
* ``init_from_env``: torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``;
  ``spawn``: ranks in spawned processes that meet in a file store.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import tempfile
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.utils import parametrize

from self_attention_tacotron_torch.parallel import shard as shard_lib
from self_attention_tacotron_torch.utils.platform import platform_device

AXES = ("data", "model")
# How long a rank waits for the others at a collective before it raises.
TIMEOUT = datetime.timedelta(minutes=15)

# The device of this process's rank, as ``init_from_env`` or ``spawn`` chose it.
_rank_device: Optional[torch.device] = None


@dataclasses.dataclass(eq=False)
class Mesh:
    """``sizes`` (data, model) over the default group's ranks; ``rank`` is this
    process's. ``device_mesh`` is the ``DeviceMesh`` of a world of more than one
    rank (None for one)."""

    sizes: Tuple[int, int]
    rank: int = 0
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.sizes))

    @property
    def size(self) -> int:
        return int(self.sizes[0] * self.sizes[1])

    @property
    def coordinate(self) -> Tuple[int, int]:
        """(data, model) index of this rank."""
        return self.rank // self.sizes[1], self.rank % self.sizes[1]

    def group(self, axis: str):
        """The process group of this rank's ``axis`` ("data" or "model"); None where
        the axis has one rank, whose collectives are the identity."""
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)


def mesh_layout(mesh_shape: Sequence[int], world_size: int) -> Tuple[int, int]:
    """(data, model) of ``mesh_shape`` over ``world_size`` ranks, as JAX's
    ``make_mesh`` reads it: ``()`` puts every rank on ``data``, a 1-tuple gets
    ``model`` 1, and a product other than the world size raises ``ValueError``."""
    if not mesh_shape:
        mesh_shape = (world_size, 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) == 1:
        mesh_shape = (mesh_shape[0], 1)
    total = int(np.prod(mesh_shape))
    if total != world_size:
        raise ValueError(f"mesh shape {mesh_shape} needs {total} devices, have {world_size}")
    if len(mesh_shape) != 2:
        raise ValueError(f"mesh shape {mesh_shape}: the mesh has two axes, data and model")
    return mesh_shape


def make_mesh(mesh_shape: Sequence[int] = (), axis_names: Tuple[str, str] = AXES) -> Mesh:
    """The mesh of ``mesh_shape`` over the default process group's ranks (one rank
    without a group); default every rank on ``data``. ``axis_names`` is JAX's
    parameter; the port's mesh has the two axes ``("data", "model")`` alone, and
    other names raise ``ValueError``."""
    if tuple(axis_names) != AXES:
        raise ValueError(f"axis names {tuple(axis_names)}: the mesh's axes are {AXES}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes = mesh_layout(mesh_shape, world)
    device_mesh = None
    if world > 1:
        from torch.distributed.device_mesh import DeviceMesh

        device_type = "cuda" if _rank_device is not None and _rank_device.type == "cuda" else "cpu"
        if dist.get_backend() == "nccl":
            device_type = "cuda"
        device_mesh = DeviceMesh(device_type, torch.arange(world).view(sizes),
                                 mesh_dim_names=AXES)
    return Mesh(tuple(sizes), rank, device_mesh)


def rank_device() -> Optional[torch.device]:
    """The device ``init_from_env`` or ``spawn`` gave this rank (None before)."""
    return _rank_device


def _set_rank_device(device: torch.device) -> torch.device:
    global _rank_device
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        # before any kernel: the wrappers launch on the current device's stream
        torch.cuda.set_device(device)
    _rank_device = device
    return device


def init_from_env() -> torch.device:
    """This rank's device, and the default process group where torchrun started more
    than one rank (``WORLD_SIZE`` > 1; ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT`` from torchrun). The device is ``platform_device()``:
    ``cuda:LOCAL_RANK``, or the CPU where ``SATT_PLATFORM=cpu``. The backend is NCCL
    on the card and gloo on the CPU. Without ``WORLD_SIZE`` the world is one rank
    and no group is made. On the card rank 0 builds the kernels while the others
    wait (``cuda_build.build_all``)."""
    dev = _set_rank_device(platform_device())
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
            rank=int(os.environ["RANK"]), world_size=world, timeout=TIMEOUT,
        )
    if dev.type == "cuda" and world > 1:
        from self_attention_tacotron_torch.utils import cuda_build

        cuda_build.build_all()
    return dev


def spawn(fn: Callable, world_size: int, args: Sequence = (), devices: Optional[Sequence[int]] = None,
          backend: Optional[str] = None) -> List[object]:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a process of its own started
    with the *spawn* method (a forked child of a process that ran torch's CPU thread
    pool can hang), joined in one process group through a file store in a
    temporary directory (no TCP port). Returns every rank's return value, in rank
    order (``torch.save``-able; keep tensors on the CPU).

    ``devices``: each rank's CUDA device index (two ranks may share one card under
    gloo); None runs the ranks on the CPU. ``backend`` defaults to gloo on the CPU
    and NCCL on the card. ``fn`` must be importable by name (a module's function).
    """
    import torch.multiprocessing as mp

    if devices is not None and len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    backend = backend or ("gloo" if devices is None else "nccl")
    with tempfile.TemporaryDirectory(prefix="satt-mesh-") as tmp:
        mp.start_processes(_spawned, args=(fn, world_size, tuple(args), devices, backend, tmp),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def _spawned(rank, fn, world_size, args, devices, backend, tmp):
    local = rank if devices is None else int(devices[rank])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(local))
    device = torch.device("cpu") if devices is None else torch.device("cuda", local)
    _set_rank_device(device)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    try:
        if device.type == "cuda":
            from self_attention_tacotron_torch.utils import cuda_build

            cuda_build.build_all()
        result = fn(*args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Placements of batches
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement on ``mesh``: ``spec`` names the mesh axis each array axis is split
    over (None: whole), as JAX's ``PartitionSpec``; ``()`` is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Axis 0 (batch) split over the data axis; the rest whole."""
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


class ShardedBatch(dict):
    """What ``shard_batch`` returns: the fields, and where this rank's rows lie.

    ``row0`` / ``rows`` / ``global_rows``: this rank's rows of the (padded) global
    batch; ``replicated``: the array fields every rank holds whole;
    ``data_parallel``: every batched field is split over a data axis of more than
    one rank, so the step runs on this rank's rows with the collectives of
    ``parallel/shard.py`` (else every rank computes the whole batch)."""

    row0: int = 0
    rows: int = 0
    global_rows: int = 0
    replicated: Tuple[str, ...] = ()
    data_parallel: bool = False


def _is_array(value) -> bool:
    if torch.is_tensor(value):
        return True
    return hasattr(value, "ndim") and np.asarray(value).dtype.kind not in ("U", "S", "O")


def _concat(head, tail):
    if torch.is_tensor(head):
        return torch.cat([head, torch.as_tensor(tail, device=head.device)], dim=0)
    return np.concatenate([np.asarray(head), tail], axis=0)


def shard_batch(batch: dict, mesh: Mesh, pad_to_data_axis: bool = True) -> ShardedBatch:
    """This rank's rows of a host batch dict, split over ``data`` (JAX's ``shard_batch``).

    When the batch does not divide the data axis and carries ``target_lengths``, it
    is padded up to the next multiple by repeating the last example, the pad rows'
    ``target_lengths`` set to 0 and ``source_lengths`` to 1 (every loss masks them;
    batch norm counts them, as JAX's does), with a warning. Other batches keep
    their size, and a field that does not divide is replicated with the warning
    "NOT data-parallel". String fields stay as they are.
    """
    data_size = mesh.shape.get("data", 1)
    d = mesh.coordinate[0]
    arrays = {k: v for k, v in batch.items() if _is_array(v)}
    out = ShardedBatch((k, v) for k, v in batch.items() if k not in arrays)   # ids stay

    batch_dims = {v.shape[0] for v in arrays.values() if v.ndim >= 1}
    uniform = len(batch_dims) == 1
    b = batch_dims.pop() if uniform else None
    can_pad = uniform and pad_to_data_axis and "target_lengths" in arrays
    if can_pad and b % data_size != 0 and data_size > 1:
        pad = (-b) % data_size
        warnings.warn(
            f"batch of {b} does not divide the data axis ({data_size}); "
            f"padding {pad} masked rows to keep data parallelism",
            stacklevel=2,
        )
        padded = {}
        for k, v in arrays.items():
            last = v[-1:].cpu().numpy() if torch.is_tensor(v) else np.asarray(v)[-1:]
            tail = np.repeat(last, pad, axis=0)
            if k == "target_lengths":
                tail = np.zeros_like(tail)   # losses mask these rows out
            elif k == "source_lengths":
                tail = np.ones_like(tail)    # keep encoder scans well-posed
            padded[k] = _concat(v, tail)
        arrays = padded
        b += pad

    replicated_keys = []
    for key, value in arrays.items():
        if value.ndim >= 1 and value.shape[0] % data_size == 0:
            n = value.shape[0] // data_size
            out[key] = value[d * n : (d + 1) * n]
        else:
            if data_size > 1:
                warnings.warn(
                    f"replicating {key!r} (dim0={tuple(value.shape[:1])}) — batch does "
                    f"not divide the {data_size}-way data axis; this batch is "
                    "NOT data-parallel",
                    stacklevel=2,
                )
            out[key] = value
            if value.ndim >= 1:
                replicated_keys.append(key)
    out.replicated = tuple(replicated_keys)
    out.data_parallel = data_size > 1 and uniform and not replicated_keys
    if out.data_parallel:
        out.rows = b // data_size
        out.row0, out.global_rows = d * out.rows, b
    else:
        out.row0, out.rows, out.global_rows = 0, (b or 0), (b or 0)
    return out


def data_shard(batch: ShardedBatch, mesh: Mesh):
    """The ``parallel.shard`` context of a step on ``batch``: its rows where the batch
    is data-parallel, else none (the plain operations)."""
    if not getattr(batch, "data_parallel", False):
        return shard_lib.data_shard(None)
    return shard_lib.data_shard(shard_lib.DataShard(
        batch.row0, batch.rows, batch.global_rows, mesh.shape["data"], mesh.group("data")))


# --------------------------------------------------------------------------- #
# Tensor-parallel parameter rules (model axis)
# --------------------------------------------------------------------------- #

#: path regex -> spec on the flax layout; first match wins, default replicate
_TP_RULES = [
    # symbol / accent / speaker embedding tables: the embedding dim
    (re.compile(r"embedding/embedding$"), lambda nd: (None, "model")),
    # transformer FFN: column-parallel then row-parallel
    (re.compile(r"ffn1/kernel$"), lambda nd: (None, "model")),
    (re.compile(r"ffn2/kernel$"), lambda nd: ("model", None)),
    # fused QKV: column-parallel
    (re.compile(r"qkv/kernel$"), lambda nd: (None, "model")),
    # wide output projections: column-parallel
    (re.compile(r"output_projection/kernel$"), lambda nd: (None, "model")),
]


def param_sharding_rules(path: str, value, mesh: Mesh) -> Sharding:
    """The placement of one parameter of flax path ``path`` whose flax-layout shape
    is ``value``'s (an array, or a shape tuple): a dimension that does not divide
    the model axis falls back to replication."""
    shape = tuple(value) if isinstance(value, (tuple, list)) else tuple(value.shape)
    model_size = mesh.shape.get("model", 1)
    if model_size > 1:
        for pattern, spec_fn in _TP_RULES:
            if pattern.search(path):
                spec = spec_fn(len(shape))
                ok = all(not (axis == "model" and dim % model_size) for dim, axis in zip(shape, spec))
                if ok and len(spec) <= len(shape):
                    return Sharding(mesh, tuple(spec) + (None,) * (len(shape) - len(spec)))
    return replicated(mesh)


def model_split_dims(net: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """``{parameter name: torch dimension split over model}`` for the parameters the
    rules place (names of the unplaced module). A flax kernel is (in, out) where
    ``nn.Linear.weight`` is (out, in): the flax axis maps through
    ``convert.flax_layout``'s permutation."""
    from self_attention_tacotron_torch import convert

    dims = {}
    for name, p in net.named_parameters():
        key, axes = convert.flax_layout(net, name)
        flax_shape = tuple(p.shape[a] for a in axes)
        spec = param_sharding_rules(key, flax_shape, mesh).spec
        if "model" in spec:
            dims[name] = axes[spec.index("model")]
    return dims


class _GatherModel(torch.autograd.Function):
    """The whole tensor from the model group's slices along ``dim``. Every rank of
    the group computes the same forward on the same rows, so the whole tensor's
    gradient is already whole on each: the backward takes this rank's slice of it
    (a reduce-scatter that sums would count it ``model`` times)."""

    @staticmethod
    def forward(ctx, part, dim, group, index):
        ctx.dim, ctx.index, ctx.width = dim, index, part.shape[dim]
        whole = shard_lib.all_gather(part.detach().movedim(dim, 0), group)
        return whole.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None, None


class _ModelSlice(nn.Module):
    """The parametrization of a placed parameter: stores this rank's slice, gives
    the whole tensor."""

    def __init__(self, mesh: Mesh, dim: int):
        super().__init__()
        self.dim, self.size, self.index = dim, mesh.shape["model"], mesh.coordinate[1]
        self.mesh = mesh

    def forward(self, part: torch.Tensor) -> torch.Tensor:
        return _GatherModel.apply(part, self.dim, self.mesh.group("model"), self.index)

    def right_inverse(self, whole: torch.Tensor) -> torch.Tensor:
        return whole.chunk(self.size, self.dim)[self.index].clone()


@dataclasses.dataclass
class Placement:
    """What ``shard_params`` did to a module: the parameter names in the unplaced
    module's order (the checkpoints' and the optimizer's canonical order) and the
    split dimension of each placed one."""

    names: Tuple[str, ...]
    dims: Dict[str, int]


def shard_params(net: nn.Module, mesh: Mesh) -> nn.Module:
    """Place ``net``'s parameters by the rules, in place; returns ``net``. With one
    rank on ``model`` nothing changes."""
    if mesh.shape.get("model", 1) == 1 or placement(net) is not None:
        return net
    names = tuple(n for n, _ in net.named_parameters())
    dims = model_split_dims(net, mesh)
    for name, dim in dims.items():
        owner, leaf = _owner(net, name)
        parametrize.register_parametrization(owner, leaf, _ModelSlice(mesh, dim), unsafe=True)
    net._mesh_placement = Placement(names, dims)
    return net


def placement(net: nn.Module) -> Optional[Placement]:
    return getattr(net, "_mesh_placement", None)


def _owner(net: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *parts, leaf = name.split(".")
    return net.get_submodule(".".join(parts)), leaf


def _canonical(name: str) -> str:
    # "a.parametrizations.weight.original" -> "a.weight"
    if ".parametrizations." in name or name.startswith("parametrizations."):
        head, _, tail = ("." + name).partition(".parametrizations.")
        return (head[1:] + "." if head[1:] else "") + tail[: -len(".original")]
    return name


def unshard_params(net: nn.Module) -> nn.Module:
    """Gather every placed parameter whole once and drop its placement, in place."""
    placed = placement(net)
    if placed is None:
        return net
    for name in placed.dims:
        owner, leaf = _owner(net, name)
        parametrize.remove_parametrizations(owner, leaf, leave_parametrized=True)
    del net._mesh_placement
    return net


def logical_parameters(net: nn.Module) -> List[torch.Tensor]:
    """The parameters whole, in the unplaced module's order (placed ones gathered, with
    autograd): what ``l2_regularization`` sums over."""
    placed = placement(net)
    if placed is None:
        return list(net.parameters())
    out = []
    for name in placed.names:
        owner, leaf = _owner(net, name)
        out.append(getattr(owner, leaf))
    return out


def _gather_slice(part: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    with torch.no_grad():
        return _GatherModel.apply(part, dim, mesh.group("model"), mesh.coordinate[1])


def whole_state_dict(net: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``net.state_dict()`` under the unplaced names, placed parameters gathered whole
    (a collective: every rank of the model group calls it)."""
    state = net.state_dict()
    placed = placement(net)
    if placed is None:
        return state
    out = {}
    for key, value in state.items():
        name = _canonical(key)
        out[name] = _gather_slice(value, mesh, placed.dims[name]) if name in placed.dims else value
    return out


def load_whole_state_dict(net: nn.Module, state: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    """Load a whole ``state_dict`` (any mesh's checkpoint) into a placed or unplaced net."""
    placed = placement(net)
    if placed is None:
        net.load_state_dict(state)
        return
    index = mesh.coordinate[1]
    local = {}
    for key in net.state_dict():
        name = _canonical(key)
        value = state[name]
        if name in placed.dims:
            value = value.chunk(mesh.shape["model"], placed.dims[name])[index].clone()
        local[key] = value
    net.load_state_dict(local)


def _name_index(net: nn.Module) -> Dict[str, int]:
    return {_canonical(n): i for i, (n, _) in enumerate(net.named_parameters())}


def whole_optimizer_state(net: nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh) -> dict:
    """``optimizer.state_dict()`` as the unplaced module's optimizer holds it: indexed
    in the unplaced parameter order, the moments of placed parameters gathered."""
    state = optimizer.state_dict()
    placed = placement(net)
    if placed is None:
        return state
    index = _name_index(net)
    moments = {}
    for j, name in enumerate(placed.names):
        entry = state["state"].get(index[name])
        if entry is None:
            continue
        entry = dict(entry)
        if name in placed.dims:
            for key, value in entry.items():
                if torch.is_tensor(value) and value.dim() > 0:
                    entry[key] = _gather_slice(value, mesh, placed.dims[name])
        moments[j] = entry
    groups = [dict(g, params=list(range(len(placed.names)))) for g in state["param_groups"]]
    return {"state": moments, "param_groups": groups}


def load_whole_optimizer_state(net: nn.Module, optimizer: torch.optim.Optimizer, state: dict,
                               mesh: Mesh) -> None:
    """Load a whole optimizer state (``whole_optimizer_state``'s form) into the
    optimizer of a placed or unplaced net."""
    placed = placement(net)
    if placed is None:
        optimizer.load_state_dict(state)
        return
    index = _name_index(net)
    moments = {}
    for j, name in enumerate(placed.names):
        entry = state["state"].get(j)
        if entry is None:
            continue
        entry = dict(entry)
        if name in placed.dims:
            for key, value in entry.items():
                if torch.is_tensor(value) and value.dim() > 0:
                    entry[key] = value.chunk(mesh.shape["model"], placed.dims[name])[
                        mesh.coordinate[1]].clone()
        moments[index[name]] = entry
    groups = [dict(g, params=list(range(len(placed.names)))) for g in state["param_groups"]]
    optimizer.load_state_dict({"state": moments, "param_groups": groups})


# --------------------------------------------------------------------------- #
# The gradients of a data-parallel step
# --------------------------------------------------------------------------- #


def sum_gradients(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum every gradient over the data axis, in place, in one collective: each rank's
    loss is its share of the global loss, so the global gradient is the sum."""
    group = mesh.group("data")
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    shard_lib.all_reduce(flat, group)
    at = 0
    for g in grads:
        g.copy_(flat[at : at + g.numel()].view_as(g))
        at += g.numel()


def gradient_norm(net: nn.Module, grads: Sequence[torch.Tensor], mesh: Mesh,
                  norm_fn: Callable) -> torch.Tensor:
    """The global norm of the whole gradients: ``norm_fn(grads)`` where nothing is
    placed; else the replicated leaves' squares plus the placed slices' squares summed
    over the model group."""
    placed = placement(net)
    if placed is None:
        return norm_fn(grads)
    sliced_ids = set()
    for name in placed.dims:
        owner, leaf = _owner(net, name)
        sliced_ids.add(id(owner.parametrizations[leaf].original))
    whole = [p.grad for p in net.parameters() if p.grad is not None and id(p) not in sliced_ids]
    parts = [p.grad for p in net.parameters() if p.grad is not None and id(p) in sliced_ids]
    sliced = torch.stack([g.float().square().sum() for g in parts]).sum().reshape(1)
    sliced = shard_lib.all_reduce(sliced, mesh.group("model"))[0]
    return torch.sqrt(sum(g.float().square().sum() for g in whole) + sliced)


def whole_gradients(net: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``{parameter name: gradient}`` under the unplaced names, placed slices gathered
    whole (every rank of the model group calls it); a parameter without a gradient
    gives zeros."""
    placed = placement(net)
    out = {}
    for name, p in net.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        name = _canonical(name)
        if placed is not None and name in placed.dims:
            grad = _gather_slice(grad, mesh, placed.dims[name])
        out[name] = grad.detach().clone()
    if placed is not None:
        out = {name: out[name] for name in placed.names}
    return out
