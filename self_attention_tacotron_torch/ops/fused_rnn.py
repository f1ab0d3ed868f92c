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

Training takes ``bigru_train`` (``bigru_train`` / ``_bigru_bwd`` of the JAX
package): a ``torch.autograd.Function`` whose forward is ``bigru`` and whose
backward recomputes the gates of every step in parallel from the outputs
shifted by one step, runs the one serial part, the recursion of the carry's
cotangent, as a second kernel (``csrc/bigru_bwd.cu``), and forms the weight
gradients and ``d_x`` as batched products. That kernel moves 16 * B * S * H
floats and does 12 * H * H operations per valid step; like the forward it is
bounded by the chain of S dependent steps, and has the forward's layout.
``BiRNN`` takes ``bigru`` in eval mode and ``bigru_train`` in train mode.
In bfloat16 the backward rounds where the JAX package's does: every product's
inputs (the recomputed gates' inputs, the cotangents entering the carry
kernel's products and the batched products, the transposed weights), with
float32 sums, float32 unrounded biases in the recompute (the forward kernel
rounds them: the reference's own skew of about one ulp), and float32 weight
gradients.

``bilstm`` replaces ``bilstm_pallas`` (``_make_lstm_kernel``): both directions
of ZoneoutEncoderV1's LSTM in one launch (``csrc/bilstm.cu``), eval mode only,
with zoneout as the interpolation ``z * prev + (1 - z) * new``. It has the
BiGRU's shape and the same bound, the chain of S dependent steps: one block per
(4 lanes, direction) keeps the carries in shared memory and streams the gate
matrix through L2 at every step. Training runs the cells step by step under
autograd, as the JAX package does (it has no training kernel for the LSTM).
``torch.nn.LSTM`` computes another function: it has no zoneout interpolation.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from self_attention_tacotron_torch.utils.cuda_build import load_library

# Launches of the CUDA kernel made by ``bigru`` in this process.
launch_count = 0
# Launches of the backward's carry kernel made by ``bigru_train`` in this process.
bwd_launch_count = 0
# Launches of the CUDA kernel made by ``bilstm`` in this process.
lstm_launch_count = 0

GRUParams = Dict[str, torch.Tensor]  # gates_kernel (C+H, 2H), gates_bias, candidate_kernel (C+H, H), candidate_bias
LSTMParams = Dict[str, torch.Tensor]  # kernel (C+H, 4H) with gates i, g, f, o; bias (4H,)

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


# --------------------------------------------------------------------------- #
# Training: the autograd function
# --------------------------------------------------------------------------- #

_PARAM_KEYS = ("gates_kernel", "gates_bias", "candidate_kernel", "candidate_bias")


def rounded(x: torch.Tensor, io: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the io type and held as float32: what enters a product
    whose sum is float32 (``preferred_element_type=float32`` in the JAX package).
    float32 io: ``x`` itself."""
    return x if io == torch.float32 else x.to(io).float()


def bigru_bwd_carry_reference(g_y, rz, n, hp, lengths, wgh_t, wch_t):
    """Plain PyTorch version of the carry kernel: ``(g_ag (2, B, S, 2H), g_ac (2, B, S, H))``.

    ``g_y`` (B, S, 2H) holds both directions' cotangents side by side; ``rz``,
    ``n``, ``hp`` are stacked over the direction, all float32; ``wgh_t`` (2, 2H, H)
    and ``wch_t`` (2, H, H) are the transposed h rows of the gate and candidate
    kernels in the io type, whose products take their cotangents rounded to it.
    The forward direction's cotangent walks S-1 -> 0, the other 0 -> S-1.
    """
    _, B, S, H = n.shape
    io = wgh_t.dtype
    wg, wc = wgh_t.float(), wch_t.float()
    g_ag, g_ac = torch.zeros_like(rz), torch.zeros_like(n)
    for d in range(2):
        g = torch.zeros(B, H, dtype=n.dtype, device=n.device)
        for t in (range(S - 1, -1, -1) if d == 0 else range(S)):
            v = (t < lengths).unsqueeze(-1).to(n.dtype)
            r, z = rz[d, :, t, :H], rz[d, :, t, H:]
            g_h = g + g_y[:, t, d * H : (d + 1) * H] * v
            g_hat = g_h * v
            ac = g_hat * (1.0 - z) * (1.0 - n[d, :, t] * n[d, :, t])
            g_rh = rounded(ac, io) @ wc[d]
            ag = torch.cat([g_rh * hp[d, :, t], g_hat * (hp[d, :, t] - n[d, :, t])], dim=-1)
            ag = ag * rz[d, :, t] * (1.0 - rz[d, :, t])
            g = g_h * (1.0 - v) + g_hat * z + g_rh * r + rounded(ag, io) @ wg[d]
            g_ag[d, :, t], g_ac[d, :, t] = ag, ac
    return g_ag, g_ac


def _bwd_kernel_fn(dtype: torch.dtype):
    name = "bigru_bwd_f32" if dtype == torch.float32 else "bigru_bwd_bf16"
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library("bigru_bwd"), name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def bigru_bwd_carry(g_y, rz, n, hp, lengths, wgh_t, wch_t):
    """The recursion of the carry's cotangent: the kernel on CUDA tensors (or
    it raises), ``bigru_bwd_carry_reference`` on CPU tensors. ``g_y``, ``rz``,
    ``n``, ``hp`` are float32; the transposed weights float32 or bfloat16, the
    kernel's io type."""
    global bwd_launch_count
    if g_y.device.type == "cpu":
        return bigru_bwd_carry_reference(g_y, rz, n, hp, lengths, wgh_t, wch_t)
    if g_y.device.type != "cuda":
        raise RuntimeError(f"bigru_train has no kernel for device {g_y.device}")
    _, B, S, H = n.shape
    operands = [x.contiguous() for x in (g_y, rz, n, hp)]
    operands.append(lengths.to(device=g_y.device, dtype=torch.int32).contiguous())
    operands += [wgh_t.contiguous(), wch_t.contiguous()]
    for x in operands[:4]:
        if x.dtype != torch.float32 or x.device != g_y.device:
            raise TypeError("bigru_train's backward takes float32 cotangents and gates on one device")
    io = wgh_t.dtype
    for x in operands[5:]:
        if x.dtype != io or io not in _IO_DTYPES or x.device != g_y.device:
            raise TypeError("the transposed weights are both float32 or both bfloat16, on one device")
    # rows at and beyond a lane's length are never written
    g_ag, g_ac = torch.zeros_like(operands[1]), torch.zeros_like(operands[2])
    with torch.cuda.device(g_y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernel_fn(io)(
            *(x.data_ptr() for x in operands), g_ag.data_ptr(), g_ac.data_ptr(), B, S, H, stream
        )
    if err != 0:
        raise RuntimeError(f"bigru_bwd kernel launch failed: CUDA error {err}")
    bwd_launch_count += 1
    return g_ag, g_ac


class _BiGRUTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, lengths, hidden, *weights):
        pf = dict(zip(_PARAM_KEYS, weights[:4]))
        pb = dict(zip(_PARAM_KEYS, weights[4:]))
        y = bigru(xs, lengths, pf, pb, hidden)
        ctx.save_for_backward(xs, lengths, y, *weights)
        ctx.hidden = hidden
        return y

    @staticmethod
    def backward(ctx, g_y):
        xs, lengths, y, *weights = ctx.saved_tensors
        H = ctx.hidden
        B, S, C = xs.shape
        io = xs.dtype
        rz, n, hp, inps, inp2s, wgh_t, wch_t = bwd_operands(xs, y, weights, H)
        g_ag, g_ac = bigru_bwd_carry(
            g_y.float(), rz, n, hp, lengths.to(xs.device), wgh_t, wch_t
        )
        grads, g_x = [], 0.0
        for d in range(2):
            wg, _, wc, _ = weights[4 * d : 4 * d + 4]
            ag, ac = g_ag[d].reshape(B * S, 2 * H), g_ac[d].reshape(B * S, H)
            # every product: inputs in the io type, float32 sums (bias gradients unrounded)
            ag_r, ac_r = rounded(ag, io), rounded(ac, io)
            grads += [
                rounded(inps[d].reshape(B * S, C + H), io).t() @ ag_r, ag.sum(dim=0),
                rounded(inp2s[d].reshape(B * S, C + H), io).t() @ ac_r, ac.sum(dim=0),
            ]
            g_x = g_x + ag_r @ rounded(wg[:C], io).t() + ac_r @ rounded(wc[:C], io).t()
        return (g_x.reshape(B, S, C).to(io), None, None, *grads)


def bwd_operands(xs, y, weights, H: int):
    """What the backward recomputes in parallel from the outputs shifted by one
    step: ``(rz (2, B, S, 2H), n (2, B, S, H), h_prev (2, B, S, H), the gate and
    candidate products' inputs per direction, wgh_t (2, 2H, H), wch_t (2, H, H))``.
    ``weights`` are the eight leaves, forward direction first. Everything is
    float32 but the transposed weights, which are in ``xs``'s io type; in
    bfloat16 the products take rounded inputs and unrounded float32 biases."""
    B, S, C = xs.shape
    io = xs.dtype
    x32, y32 = xs.float(), y.float()
    zero = torch.zeros(B, 1, H, dtype=torch.float32, device=y.device)
    # the carry entering step t is the output of the step before it: y is the
    # carry masked by validity, and a masked step gets no gradient
    hps = (torch.cat([zero, y32[:, :-1, :H]], dim=1), torch.cat([y32[:, 1:, H:], zero], dim=1))
    rzs, ns, inps, inp2s = [], [], [], []
    for d, hp in enumerate(hps):
        wg, bg, wc, bc = weights[4 * d : 4 * d + 4]
        inp = torch.cat([x32, hp], dim=-1)
        rz = torch.sigmoid(rounded(inp, io) @ rounded(wg, io) + bg)
        inp2 = torch.cat([x32, rz[..., :H] * hp], dim=-1)
        rzs.append(rz)
        ns.append(torch.tanh(rounded(inp2, io) @ rounded(wc, io) + bc))
        inps.append(inp)
        inp2s.append(inp2)
    wgh_t = torch.stack([weights[0][C:].t(), weights[4][C:].t()]).to(io)
    wch_t = torch.stack([weights[2][C:].t(), weights[6][C:].t()]).to(io)
    return torch.stack(rzs), torch.stack(ns), torch.stack(hps), inps, inp2s, wgh_t, wch_t


def bigru_train(
    xs: torch.Tensor,            # (B, S, C) float32 or bfloat16
    lengths: torch.Tensor,       # (B,) integer
    params_fwd: GRUParams,
    params_bwd: GRUParams,
    hidden: int,
) -> torch.Tensor:
    """Differentiable ``bigru``: the same forward, and a backward whose serial
    part is the kernel of ``csrc/bigru_bwd.cu``.

    Gradients flow to ``xs`` (in its type) and to the eight weight tensors (in
    theirs, float32). CUDA tensors go to the two kernels or raise; CPU tensors
    go through the same function with the kernels' plain versions. ``xs`` in
    float32 or bfloat16, the io type of both kernels; the weights are cast
    inside.
    """
    if xs.dtype not in _IO_DTYPES:
        raise TypeError(f"bigru_train takes float32 or bfloat16, got {xs.dtype}")
    weights = [params_fwd[k] for k in _PARAM_KEYS] + [params_bwd[k] for k in _PARAM_KEYS]
    return _BiGRUTrain.apply(xs, lengths, int(hidden), *weights)


# --------------------------------------------------------------------------- #
# Bidirectional ZoneoutLSTM, eval mode
# --------------------------------------------------------------------------- #


def _lstm_direction(xs, lengths, p: LSTMParams, hidden: int, zc: float, zo: float,
                    forget_bias: float, reverse: bool) -> torch.Tensor:
    """One direction, with the kernel's roundings: io(h) enters the product, which
    is summed in float32; the carries stay float32."""
    B, S, _ = xs.shape
    io = xs.dtype
    w, b = p["kernel"].to(io).float(), p["bias"].to(io).float()
    c = torch.zeros(B, hidden, dtype=torch.float32, device=xs.device)
    h = torch.zeros(B, hidden, dtype=torch.float32, device=xs.device)
    ys = torch.zeros(B, S, hidden, dtype=io, device=xs.device)
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        z = torch.cat([xs[:, t], h.to(io)], dim=-1).float() @ w + b
        i, g, f, o = z.chunk(4, dim=-1)
        new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        new_c = zc * c + (1.0 - zc) * new_c
        new_h = zo * h + (1.0 - zo) * new_h
        valid = (t < lengths).unsqueeze(-1)
        c = torch.where(valid, new_c, c)
        h = torch.where(valid, new_h, h)
        ys[:, t] = torch.where(valid, h, torch.zeros_like(h)).to(io)
    return ys


def bilstm_reference(
    xs: torch.Tensor,            # (B, S, C) float32 or bfloat16
    lengths: torch.Tensor,       # (B,) integer
    params_fwd: LSTMParams,
    params_bwd: LSTMParams,
    hidden: int,
    zoneout_cell: float = 0.0,
    zoneout_output: float = 0.0,
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version of ``bilstm``: (B, S, 2H) in ``xs``'s type."""
    lengths = lengths.to(xs.device)
    args = (hidden, float(zoneout_cell), float(zoneout_output), float(forget_bias))
    return torch.cat(
        [
            _lstm_direction(xs, lengths, params_fwd, *args, reverse=False),
            _lstm_direction(xs, lengths, params_bwd, *args, reverse=True),
        ],
        dim=-1,
    )


def _lstm_kernel_fn(dtype: torch.dtype):
    name = "bilstm_f32" if dtype == torch.float32 else "bilstm_bf16"
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library("bilstm"), name)
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def bilstm(
    xs: torch.Tensor,            # (B, S, C) float32 or bfloat16
    lengths: torch.Tensor,       # (B,) integer
    params_fwd: LSTMParams,
    params_bwd: LSTMParams,
    hidden: int,
    zoneout_cell: float = 0.0,
    zoneout_output: float = 0.0,
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """Both directions of the eval-mode ZoneoutLSTM, (B, S, 2H) in ``xs``'s type.

    A CUDA tensor goes to the kernel or raises; a CPU tensor goes to
    ``bilstm_reference``. Not differentiable: the kernel serves evaluation.
    """
    global lstm_launch_count
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, S, C), got {tuple(xs.shape)}")
    if xs.dtype not in _IO_DTYPES:
        raise TypeError(f"xs must be float32 or bfloat16, got {xs.dtype}")
    args = (hidden, zoneout_cell, zoneout_output, forget_bias)
    if xs.device.type == "cpu":
        return bilstm_reference(xs, lengths, params_fwd, params_bwd, *args)
    if xs.device.type != "cuda":
        raise RuntimeError(f"bilstm has no kernel for device {xs.device}")
    B, S, C = xs.shape
    H = int(hidden)
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    weights = []
    for p in (params_fwd, params_bwd):
        for key, shape in (("kernel", (C + H, 4 * H)), ("bias", (4 * H,))):
            w = p[key]
            if tuple(w.shape) != shape:
                raise ValueError(f"{key}: expected shape {shape}, got {tuple(w.shape)}")
            if w.device != xs.device:
                raise ValueError(f"{key} is on {w.device}, the input on {xs.device}")
            weights.append(w.detach().to(xs.dtype).contiguous())
    xs_c = xs.detach().contiguous()
    len_c = lengths.to(device=xs.device, dtype=torch.int32).contiguous()
    y = torch.empty(B, S, 2 * H, dtype=xs.dtype, device=xs.device)
    fn = _lstm_kernel_fn(xs.dtype)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xs_c.data_ptr(), len_c.data_ptr(), *(w.data_ptr() for w in weights), y.data_ptr(),
            B, S, C, H, float(zoneout_cell), float(zoneout_output), float(forget_bias), stream,
        )
    if err != 0:
        raise RuntimeError(f"bilstm kernel launch failed: CUDA error {err}")
    lstm_launch_count += 1
    return y
