"""Bidirectional GRU over a padded batch: CUDA kernel, plain version, wrapper.

``bigru`` replaces ``bigru_pallas`` of the JAX package
(``self_attention_tacotron_tpu/ops/fused_rnn.py``, ``_make_kernel``): both
directions of the CBHG's GRU in one launch, length-masked. A padded step keeps
the carry and emits zero; the backward direction walks S-1 -> 0.

What bounds it on an H100: nothing the card is short of. The work is
2 * sum(lengths) * 2 * (C + H) * 3H operations and a few megabytes, but the S
steps depend on each other, so the time is S times the latency of one step. The
kernel (``csrc/bigru.cu``) therefore keeps the whole loop in one launch, with
the carries in shared memory and the weights read through L2, gives every
(group of 4 lanes, direction) its own block, and stops each block at the longest
length among its lanes.

The cell is ``GRUCell`` of ``models/modules.py``: the candidate takes
``[x, r * h]``. It is not cuDNN's GRU, whose candidate is ``r * (W_h h)``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from self_attention_tacotron_torch.utils.cuda_build import load_library

# Launches of the CUDA kernel made by ``bigru`` in this process.
launch_count = 0

GRUParams = Dict[str, torch.Tensor]  # gates_kernel (C+H, 2H), gates_bias, candidate_kernel (C+H, H), candidate_bias

_IO_DTYPES = (torch.float32, torch.bfloat16)
_functions = {}


def _gru_direction(xs, lengths, p: GRUParams, hidden: int, reverse: bool) -> torch.Tensor:
    """One direction, with the kernel's roundings: io(h) and io(r*h) enter the products,
    which are summed in float32."""
    B, S, _ = xs.shape
    io = xs.dtype
    wg, bg = p["gates_kernel"].to(io), p["gates_bias"].to(io)
    wc, bc = p["candidate_kernel"].to(io), p["candidate_bias"].to(io)
    h = torch.zeros(B, hidden, dtype=torch.float32, device=xs.device)
    ys = torch.zeros(B, S, hidden, dtype=io, device=xs.device)
    steps = range(S - 1, -1, -1) if reverse else range(S)
    for t in steps:
        x_t = xs[:, t]
        rz = torch.sigmoid(
            torch.cat([x_t, h.to(io)], dim=-1).float() @ wg.float() + bg.float()
        )
        r, z = rz[:, :hidden], rz[:, hidden:]
        n = torch.tanh(
            torch.cat([x_t, (r * h).to(io)], dim=-1).float() @ wc.float() + bc.float()
        )
        new = (1.0 - z) * n + z * h
        valid = (t < lengths).unsqueeze(-1)
        h = torch.where(valid, new, h)
        ys[:, t] = torch.where(valid, h, torch.zeros_like(h)).to(io)
    return ys


def bigru_reference(
    xs: torch.Tensor,            # (B, S, C) float32 or bfloat16
    lengths: torch.Tensor,       # (B,) integer
    params_fwd: GRUParams,
    params_bwd: GRUParams,
    hidden: int,
) -> torch.Tensor:
    """Plain PyTorch version of ``bigru``: (B, S, 2H) in ``xs``'s type."""
    lengths = lengths.to(xs.device)
    return torch.cat(
        [
            _gru_direction(xs, lengths, params_fwd, hidden, reverse=False),
            _gru_direction(xs, lengths, params_bwd, hidden, reverse=True),
        ],
        dim=-1,
    )


def _kernel_fn(dtype: torch.dtype):
    name = "bigru_f32" if dtype == torch.float32 else "bigru_bf16"
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library("bigru"), name)
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def _weights(p: GRUParams, io: torch.dtype, device, C: int, H: int) -> Sequence[torch.Tensor]:
    shapes = {
        "gates_kernel": (C + H, 2 * H), "gates_bias": (2 * H,),
        "candidate_kernel": (C + H, H), "candidate_bias": (H,),
    }
    out = []
    for key, shape in shapes.items():
        w = p[key]
        if tuple(w.shape) != shape:
            raise ValueError(f"{key}: expected shape {shape}, got {tuple(w.shape)}")
        if w.device != device:
            raise ValueError(f"{key} is on {w.device}, the input on {device}")
        out.append(w.detach().to(io).contiguous())
    return out


def bigru(
    xs: torch.Tensor,            # (B, S, C) float32 or bfloat16
    lengths: torch.Tensor,       # (B,) integer
    params_fwd: GRUParams,
    params_bwd: GRUParams,
    hidden: int,
) -> torch.Tensor:
    """Both directions of the GRU, (B, S, 2H) in ``xs``'s type.

    A CUDA tensor goes to the kernel or raises; a CPU tensor goes to
    ``bigru_reference``.
    """
    global launch_count
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, S, C), got {tuple(xs.shape)}")
    if xs.dtype not in _IO_DTYPES:
        raise TypeError(f"xs must be float32 or bfloat16, got {xs.dtype}")
    if xs.device.type == "cpu":
        return bigru_reference(xs, lengths, params_fwd, params_bwd, hidden)
    if xs.device.type != "cuda":
        raise RuntimeError(f"bigru has no kernel for device {xs.device}")
    B, S, C = xs.shape
    H = int(hidden)
    xs_c = xs.detach().contiguous()
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    len_c = lengths.to(device=xs.device, dtype=torch.int32).contiguous()
    wf = _weights(params_fwd, xs.dtype, xs.device, C, H)
    wb = _weights(params_bwd, xs.dtype, xs.device, C, H)
    y = torch.empty(B, S, 2 * H, dtype=xs.dtype, device=xs.device)
    fn = _kernel_fn(xs.dtype)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xs_c.data_ptr(), len_c.data_ptr(),
            *(w.data_ptr() for w in wf), *(w.data_ptr() for w in wb),
            y.data_ptr(), B, S, C, H, stream,
        )
    if err != 0:
        raise RuntimeError(f"bigru kernel launch failed: CUDA error {err}")
    launch_count += 1
    return y
