"""Full-sequence multi-head self-attention: CUDA kernel, plain version, wrapper.

``mha_full`` replaces ``mha_full_pallas`` of the JAX package
(``self_attention_tacotron_tpu/ops/fused_attention.py``, ``_make_kernel``): per
batch row and head, ``q . k^T / sqrt(HD) + key bias`` -> float32 softmax ->
probabilities, and ``probs . v``. Non-causal only. The qkv and output
projections stay ``nn.Linear`` around it.

What bounds it on an H100: at the flagship shape (B=32, T=128, D=256, 2 heads)
the function moves 21 MB (qkv, ctx and the (B, H, T, T) float32 probabilities)
and does 4 * B * H * T^2 * HD = 0.54 GFLOP. In float32, outside the tensor
cores, the operations bound it; in bfloat16 the bytes do. The kernel
(``csrc/mha_full.cu``) moves each byte once: it keeps the logits in shared
memory and writes each probability once. It uses plain float32 multiply-adds
and no tensor cores yet.

No single PyTorch call computes this function:
``scaled_dot_product_attention`` returns no probabilities.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from self_attention_tacotron_torch.utils.cuda_build import load_library

# Launches of the CUDA kernel made by ``mha_full`` in this process.
launch_count = 0

_NEG_INF = -1e9
_IO_DTYPES = (torch.float32, torch.bfloat16)
_functions = {}


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
    qkv_c = qkv.detach().contiguous()
    mask_c = None if mask is None else mask.contiguous()
    ctx = torch.empty(B, T, D, dtype=qkv.dtype, device=qkv.device)
    probs = torch.empty(B, num_heads, T, T, dtype=torch.float32, device=qkv.device)
    fn = _kernel_fn(qkv.dtype)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            qkv_c.data_ptr(), None if mask_c is None else mask_c.data_ptr(),
            ctx.data_ptr(), probs.data_ptr(), B, T, D, int(num_heads), stream,
        )
    if err != 0:
        raise RuntimeError(f"mha_full kernel launch failed: CUDA error {err}")
    launch_count += 1
    return ctx, probs
