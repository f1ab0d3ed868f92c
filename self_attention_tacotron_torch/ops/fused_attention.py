"""Full-sequence multi-head self-attention: CUDA kernel, plain version, wrapper.

``mha_full`` replaces ``mha_full_pallas`` of the JAX package
(``self_attention_tacotron_tpu/ops/fused_attention.py``, ``_make_kernel``): per
batch row and head, ``q . k^T / sqrt(HD) + key bias`` -> float32 softmax ->
probabilities, and ``io(probs) . v``. Non-causal only. The qkv and output
projections stay ``nn.Linear`` around it.

What bounds it on an H100: at the flagship shape (B=32, T=128, D=256, 2 heads)
the function moves 21 MB (qkv, ctx and the (B, H, T, T) float32 probabilities)
and does 4 * B * H * T^2 * HD = 0.54 GFLOP. In float32, outside the tensor
cores, the operations bound it; in bfloat16, on the tensor cores, the bytes do.
The kernel (``csrc/mha_full.cu``) runs one block per (lane, head, 64 query rows),
K and V in double-buffered tiles of 64 keys, the products on register tiles
(bfloat16: ``mma.sync`` with ``ldmatrix`` fragments; float32: FFMA, 4 x 4 outputs
a thread, no TF32), and two passes over the keys: the logits, their row maxima and
sums, then each probability written once and ``ctx += io(p) . V``. The logits rows
stay in shared memory where T fits beside the tiles (``MhaPlan.lk`` keys), else in
the block's own rows of ``probs``: a block's shared memory does not grow with T,
and every T launches. ``mha_full_plan`` mirrors the plan; a head wider than
``MHA_HD_MAX`` raises ``ValueError``.

No single PyTorch call computes this function:
``scaled_dot_product_attention`` returns no probabilities.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch

from self_attention_tacotron_torch.utils.cuda_build import load_library

# Launches of the CUDA kernel made by ``mha_full`` in this process.
launch_count = 0

_NEG_INF = -1e9
_IO_DTYPES = (torch.float32, torch.bfloat16)
_functions = {}

# The kernel's plan (csrc/mha_full.cu::mha_plan, mirrored): query rows a block, keys a
# tile, threads, the widest head it holds, the most keys of the logits rows kept in
# shared memory, and the opt-in shared memory of one block on an H100.
MHA_ROWS, MHA_KEYS, MHA_THREADS = 64, 64, 256
MHA_HD_MAX = 256
MHA_LK_MAX = 512
MHA_SMEM_LIMIT = 232448
_TOO_WIDE = -3


@dataclass(frozen=True)
class MhaPlan:
    """How ``csrc/mha_full.cu`` runs: the fields its C query writes, in that order."""

    rows: int           # query rows a block
    keys: int           # keys a tile of K or V
    threads: int
    hd: int             # head width
    hd_padded: int      # padded with zeros to the products' tile
    ld: int             # row stride of the q and K/V tiles, values
    pld: int            # row stride of the io(p) tile, values
    lk: int             # keys of the logits rows in shared memory (0: none)
    on_chip: int        # T <= lk: the logits stay in shared memory, else in probs' rows
    grid_x: int         # tiles of query rows
    grid_y: int         # heads
    grid_z: int         # lanes
    smem_bytes: int     # shared memory of a block, the same at every T
    smem_limit: int


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def mha_full_plan(B: int, T: int, D: int, H: int, io: torch.dtype,
                  smem_limit: int = MHA_SMEM_LIMIT) -> MhaPlan:
    """The plan ``csrc/mha_full.cu`` launches with: the grid (T / 64 rounded up, H,
    B), the tiles and their padded strides, and the block's shared memory: q rows,
    two K/V tiles, the io(p) tile, the rows' maxima and sums and, where ``lk`` > 0,
    the logits of ``lk`` keys a row (row stride ``lk + 16``; the most that fit beside
    the rest, a multiple of 64, at most 512). T decides only whether the logits stay
    on chip. ``ValueError`` for a head wider than ``MHA_HD_MAX``."""
    if D % H != 0:
        raise ValueError(f"D={D} is not a multiple of num_heads={H}")
    hd = D // H
    if hd > MHA_HD_MAX:
        raise ValueError(
            f"mha_full: a head of {hd} values is wider than the kernel holds "
            f"(MHA_HD_MAX = {MHA_HD_MAX}: two tiles of 64 keys and 64 query rows of it "
            f"in the {smem_limit} bytes of shared memory a block may have)")
    es = torch.empty((), dtype=io).element_size()
    hdp = -(-hd // 32) * 32 if es == 2 else -(-hd // 8) * 8
    ld = hdp + (8 if es == 2 else 4)
    pld = MHA_KEYS + (8 if es == 2 else 4)
    off_l = (_r16(MHA_ROWS * ld * es) + _r16(2 * MHA_KEYS * ld * es)
             + _r16(MHA_ROWS * pld * es) + 8 * MHA_ROWS)
    room = (smem_limit - off_l) // (4 * MHA_ROWS) - 16
    lk = 0 if room < 0 else (MHA_LK_MAX if room >= MHA_LK_MAX else room // MHA_KEYS * MHA_KEYS)
    return MhaPlan(
        rows=MHA_ROWS, keys=MHA_KEYS, threads=MHA_THREADS, hd=hd, hd_padded=hdp, ld=ld,
        pld=pld, lk=lk, on_chip=int(T <= lk), grid_x=-(-T // MHA_ROWS), grid_y=H, grid_z=B,
        smem_bytes=off_l + (4 * MHA_ROWS * (lk + 16) if lk > 0 else 0), smem_limit=smem_limit)


def mha_full_device_plan(B: int, T: int, D: int, H: int, io: torch.dtype, device) -> MhaPlan:
    """The plan the built kernel computes for itself on ``device`` (its C query)."""
    query = load_library("mha_full").mha_full_plan_query
    query.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    query.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(fields(MhaPlan)))()
    with torch.cuda.device(device):
        err = query(int(B), int(T), int(D), int(H), int(io == torch.bfloat16),
                    ctypes.addressof(out))
    _raise_on(err)
    return MhaPlan(*(int(v) for v in out))


def _raise_on(err: int) -> None:
    if err == _TOO_WIDE:
        raise ValueError(f"mha_full: the head is wider than MHA_HD_MAX = {MHA_HD_MAX}")
    if err != 0:
        raise RuntimeError(f"mha_full kernel launch failed: CUDA error {err}")


def mha_full_reference(
    qkv: torch.Tensor,                 # (B, T, 3D) packed query | key | value
    mask: Optional[torch.Tensor],      # (B, T) bool, True where the key is valid
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``mha_full``: ctx (B, T, D), probs (B, H, T, T) float32."""
    B, T, three_d = qkv.shape
    D = three_d // 3
    hd = D // num_heads
    q, k, v = (
        p.reshape(B, T, num_heads, hd).permute(0, 2, 1, 3) for p in qkv.split(D, dim=-1)
    )
    # products of io-type values, summed in float32, as the kernel sums them
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        bias = torch.where(mask, 0.0, _NEG_INF).to(torch.float32)
        logits = logits + bias[:, None, None, :]
    lmax = logits.max(dim=-1, keepdim=True).values
    lexp = torch.exp(logits - lmax)
    probs = lexp / lexp.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(probs.to(v.dtype).float(), v.float()).to(qkv.dtype)
    return ctx.permute(0, 2, 1, 3).reshape(B, T, D), probs


def _kernel_fn(dtype: torch.dtype):
    name = "mha_full_f32" if dtype == torch.float32 else "mha_full_bf16"
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library("mha_full"), name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def mha_full(
    qkv: torch.Tensor,                 # (B, T, 3D) float32 or bfloat16
    mask: Optional[torch.Tensor],      # (B, T) bool or None
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Context (B, T, D) in ``qkv``'s type and probabilities (B, H, T, T) float32.

    A CUDA tensor goes to the kernel or raises; a CPU tensor goes to
    ``mha_full_reference``.
    """
    global launch_count
    if qkv.dim() != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"qkv must be (B, T, 3D), got {tuple(qkv.shape)}")
    B, T, three_d = qkv.shape
    D = three_d // 3
    if D % num_heads != 0:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    if qkv.dtype not in _IO_DTYPES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (B, T)):
        raise ValueError(f"mask must be bool ({B}, {T}), got {mask.dtype} {tuple(mask.shape)}")
    if qkv.device.type == "cpu":
        return mha_full_reference(qkv, mask, num_heads)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"mha_full has no kernel for device {qkv.device}")
    if mask is not None and mask.device != qkv.device:
        raise ValueError(f"mask is on {mask.device}, qkv on {qkv.device}")
    if D // num_heads > MHA_HD_MAX:
        mha_full_plan(B, T, D, int(num_heads), qkv.dtype)   # raises, naming the limit
    qkv_c = qkv.detach().contiguous()
    mask_c = None if mask is None else mask.contiguous()
    ctx = torch.empty(B, T, D, dtype=qkv.dtype, device=qkv.device)
    probs = torch.empty(B, num_heads, T, T, dtype=torch.float32, device=qkv.device)
    fn = _kernel_fn(qkv.dtype)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(
            qkv_c.data_ptr(), None if mask_c is None else mask_c.data_ptr(),
            ctx.data_ptr(), probs.data_ptr(), B, T, D, int(num_heads), stream,
        )
    _raise_on(err)
    launch_count += 1
    return ctx, probs
