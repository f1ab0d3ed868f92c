"""The teacher-forced decoder scan, forward and backward: CUDA kernels, plain version, wrapper.

``teacher_decode`` replaces ``teacher_decode`` of the JAX package
(``self_attention_tacotron_tpu/ops/fused_teacher.py``; its two kernels are
``_run_fwd`` and ``_run_bwd``). In teacher forcing the decoder's inputs are
known for all N steps, so the prenet runs here as two batched products over
(B * N) rows, outside any kernel, and the scanned region (attention ZoneoutLSTM,
the fused dual query projection, both sources' additive scores, the
forward-attention recursion with or without the transition agent, contexts, two
decoder ZoneoutLSTMs) runs as one kernel launch per direction
(``csrc/fused_teacher.cu``):

* forward: N steps in one launch; writes features (B, N, DU), alignments
  (B, N, 2S), and per step one carry row and one activation row (see
  ``row_layouts``) for the backward;
* backward: the adjoint chain N-1 .. 0 in one launch; reads those rows,
  regenerates the zoneout masks, recomputes only the (S, A) score tanh, writes
  ``d_keys``, ``d_spk``, one ``d_vblk`` partial per lane, one gradient row per step
  and their float32 running sum. Every weight gradient is then one batched
  product here, against inputs rebuilt from the carry rows (``grads_from_rows``),
  the memories' gradients come from the alignments and the context cotangents,
  and the prenet's gradients by autograd through the hoisted products.

What bounds both kernels on an H100 is the chain of N dependent steps: a step
needs about 2 * 2.5 M * B operations and re-reads 10 MB of float32 weights
through L2, far from what the card can do in the time the dependent stages of a
step take. One block per 4 lanes walks all steps on its own; see the source.

Zoneout masks are not stored. In training the keep mask of (step, draw, lane,
unit) is a counter-based hash of ``seed + t`` with a murmur3 finalizer, the one
the JAX package's kernels use in interpret mode, with the global lane as the
row, so it does not depend on how lanes are grouped into blocks; the plain
version draws the same masks (``hash_keep_masks``). In evaluation the mask is
the constant zoneout factor.

Specialised to the flagship family: dual source, forward attention (with or
without transition agent) on source 1, additive attention on source 2, optional
speaker embedding, two prenet layers, two decoder LSTMs, float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from self_attention_tacotron_torch.utils.cuda_build import load_library

# Launches of the forward and of the backward kernel made in this process.
launch_count = 0
bwd_launch_count = 0
# CUDA events around the last launch of each kernel ("fwd", "bwd"); see ``last_launch_ms``.
_launch_events = {}

_EPS = 1e-6
_MASK32 = 0xFFFFFFFF

# Order of the entries in the flat weight buffer; the enum ``Entry`` of the source
# lists the same names in the same order. The last four are transposed copies.
_ENTRIES = (
    "attg_w", "attg_b", "qp_w", "vblk", "ta_w", "ta_b", "l1_w", "l1_b", "l2_w", "l2_b",
    "attg_wt", "qp_wt", "l1_wt", "l2_wt",
)
# Order of the sizes handed to the kernels, after (B, S, N).
_SIZES = ("P2", "SPK", "AU", "A1", "A2", "DU", "E1", "E2")
# Fields of the per-step rows, in the order of the source's enums.
_CARRY = ("c_att", "h_att", "c1", "h1", "c2", "h2", "ctx1", "ctx2", "alpha", "u")
_ACTS = ("z_att", "z1", "z2", "qp", "y1", "alpha2")
_STACK = ("g_z_att", "g_z1", "g_z2", "g_feed", "g_qp", "g_ctx1", "g_ctx2", "g_u_pre")
# Names of the weights of the scanned region, as ``teacher_decode`` takes them.
CORE_WEIGHTS = (
    "w_attg", "b_attg", "w_qp", "vblk", "w_ta", "b_ta", "w_l1", "b_l1", "w_l2", "b_l2",
)

_functions = {}


def _require(condition: bool, message: str) -> None:
    if not condition:
        raise ValueError(f"fused_teacher: {message}")


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


# --------------------------------------------------------------------------- #
# Which configurations the kernels serve
# --------------------------------------------------------------------------- #


def supports_fused_teacher(hp) -> bool:
    """True for the flagship family that the kernels are specialised to.

    Dual source, forward attention with or without the transition agent on
    source 1, additive attention on source 2, two prenet layers, float32. The
    kernels read memory rows 16 bytes at a time, so those widths are multiples
    of 4; and the first decoder LSTM has no residual, which holds whenever its
    input and output widths differ.
    """
    return bool(
        hp.decoder == "DualSourceSelfAttentionDecoder"
        and hp.attention in ("forward", "forward_transition_agent")
        and hp.attention2 == "additive"
        and len(hp.decoder_prenet_out_units) == 2
        and hp.compute_dtype == "float32"
        and hp.cbhg_out_units % 4 == 0
        and hp.self_attention_out_units % 4 == 0
        and hp.attention_out_units + hp.cbhg_out_units + hp.self_attention_out_units
        != hp.decoder_out_units
    )


# --------------------------------------------------------------------------- #
# Row layouts and zoneout masks: one description for wrapper and plain version
# --------------------------------------------------------------------------- #


def row_layouts(z: Dict[str, int], src_len: int) -> Dict[str, Tuple[Dict[str, Tuple[int, int]], int]]:
    """``{"carry" | "acts" | "stack": ({field: (offset, width)}, row width)}``, in floats.

    carry: the state after a step (what the next step starts from); acts: what a
    step computed on the way and the backward does not recompute; stack: the
    cotangents a step hands to the batched weight-gradient products.
    """
    A, S = z["A1"] + z["A2"], src_len
    widths = {
        "carry": (z["AU"], z["AU"], z["DU"], z["DU"], z["DU"], z["DU"], z["E1"], z["E2"], S, 1),
        "acts": (4 * z["AU"], 4 * z["DU"], 4 * z["DU"], A, S, S),
        "stack": (4 * z["AU"], 4 * z["DU"], 4 * z["DU"], z["P2"], A, z["E1"], z["E2"], 1),
    }
    out = {}
    for kind, names in (("carry", _CARRY), ("acts", _ACTS), ("stack", _STACK)):
        fields, at = {}, 0
        for name, width in zip(names, widths[kind]):
            fields[name] = (at, width)
            at += width
        out[kind] = (fields, at)
    return out


def _col(rows: torch.Tensor, layout, name: str) -> torch.Tensor:
    at, width = layout[0][name]
    return rows[..., at : at + width]


def keep_threshold(p: float) -> int:
    """A unit keeps its previous state where the hash's 32 bits are below this."""
    return min(int(p * 2**32), 2**32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # x * c modulo 2**32 on int64 values below 2**32, without leaving int64
    low = (x & 0xFFFF) * c
    high = (((x >> 16) * c) & 0xFFFF) << 16
    return (low + high) & _MASK32


def hash_keep_masks(seed: int, num_steps: int, batch: int, width: int, draw: int,
                    threshold: int, device) -> torch.Tensor:
    """(N, B, width) boolean keep masks of draw number ``draw`` for every step.

    bits = murmur3_finalizer((seed + t) * 0x9E3779B9 + draw * 0x85EBCA6B
    + (lane * width + unit) * 0xC2B2AE35), all modulo 2**32; keep where
    bits < threshold.
    """
    t = torch.arange(num_steps, dtype=torch.int64, device=device)
    base = (_mul32((t + int(seed)) & _MASK32, 0x9E3779B9) + ((draw * 0x85EBCA6B) & _MASK32))
    idx = torch.arange(batch * width, dtype=torch.int64, device=device).view(batch, width)
    x = (base[:, None, None] + _mul32(idx & _MASK32, 0xC2B2AE35)[None]) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x < threshold


def _draw_numbers(zc: float, zo: float) -> List[int]:
    """Draw number of (cell, c) and (cell, h) for the three cells: c then h per
    cell, counted from 1, a kind at factor 0 is not drawn (0 here)."""
    numbers, count = [], 0
    for _ in range(3):
        for factor in (zc, zo):
            if factor > 0.0:
                count += 1
                numbers.append(count)
            else:
                numbers.append(0)
    return numbers


def zoneout_keep_masks(hp_like: Dict, seed: int, num_steps: int, batch: int, device):
    """Per cell (attention LSTM, decoder LSTM 1 and 2) the pair (keep_c, keep_h).

    In training each is a (N, B, units) float mask from the hash; in evaluation
    the constant factor; None where the factor is 0.
    """
    zc, zo = float(hp_like["zoneout_cell"]), float(hp_like["zoneout_output"])
    units = (hp_like["att_units"], hp_like["dec_units"], hp_like["dec_units"])
    draws = _draw_numbers(zc, zo)
    masks = []
    for cell, width in enumerate(units):
        pair = []
        for kind, factor in enumerate((zc, zo)):
            if factor <= 0.0:
                pair.append(None)
            elif hp_like.get("eval_zoneout", False):
                pair.append(factor)
            else:
                pair.append(hash_keep_masks(
                    seed, num_steps, batch, width, draws[2 * cell + kind],
                    keep_threshold(factor), device,
                ).to(torch.float32))
        masks.append(tuple(pair))
    return masks


# --------------------------------------------------------------------------- #
# The plain PyTorch version
# --------------------------------------------------------------------------- #


def _prenet(weights, feeds, drop_rate: float, prenet_masks, generator):
    """Both prenet layers over all (B, N) rows; dropout from the masks given
    ((B, N, units) boolean keep masks per layer) or drawn from ``generator``."""
    keep = 1.0 - drop_rate
    x = feeds
    for i, (w, b) in enumerate((("w_p1", "b_p1"), ("w_p2", "b_p2"))):
        # torch.relu gives gradient 0 at exactly 0, where the zero go frame lands
        x = torch.relu(x @ weights[w] + weights[b])
        if prenet_masks is not None:
            mask = prenet_masks[i]
        elif drop_rate > 0.0:
            mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
        else:
            continue
        x = torch.where(mask, x / keep, torch.zeros_like(x))
    return x


def _zoneout_lstm(z, c, h, keep_c, keep_h, forget_bias: float):
    i, g, f, o = z.chunk(4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    out_c = new_c if keep_c is None else c * keep_c + new_c * (1.0 - keep_c)
    out_h = new_h if keep_h is None else h * keep_h + new_h * (1.0 - keep_h)
    return out_c, out_h


def _core_plain(hp_like, w, x2, keys, mem1, mem2, score_bias, spk, seed: int, taps=None):
    """The scanned region step by step, in the kernels' formulation.

    ``taps``: a list that receives, per step, the tensors of the carry and
    activation rows and those whose gradients make the gradient row.
    """
    B, N, _ = x2.shape
    f32 = dict(dtype=torch.float32, device=x2.device)
    AU, DU = hp_like["att_units"], hp_like["dec_units"]
    fb = float(hp_like.get("forget_bias", 1.0))
    masks = zoneout_keep_masks(hp_like, seed, N, B, x2.device)
    step_mask = lambda m, t: m[t] if torch.is_tensor(m) else m  # noqa: E731

    c_att, h_att = torch.zeros(B, AU, **f32), torch.zeros(B, AU, **f32)
    c1, h1, c2, h2 = (torch.zeros(B, DU, **f32) for _ in range(4))
    ctx1 = torch.zeros(B, mem1.shape[-1], **f32)
    ctx2 = torch.zeros(B, mem2.shape[-1], **f32)
    alpha1 = torch.zeros(B, keys.shape[1], **f32)
    alpha1[:, 0] = 1.0
    u = torch.full((B, 1), 0.5, **f32)
    features, aligns = [], []
    for t in range(N):
        x_t = x2[:, t]
        parts = [x_t] + ([spk] if spk is not None else []) + [ctx1, ctx2, h_att]
        z_att = torch.cat(parts, dim=-1) @ w["w_attg"] + w["b_attg"]
        c_att, h_att = _zoneout_lstm(
            z_att, c_att, h_att, step_mask(masks[0][0], t), step_mask(masks[0][1], t), fb
        )
        qp = h_att @ w["w_qp"]
        e = torch.tanh(keys + qp[:, None, :]) @ w["vblk"]          # (B, S, 2)
        y1 = torch.softmax(e[..., 0] + score_bias, dim=-1)
        shifted = torch.nn.functional.pad(alpha1, (1, 0))[:, :-1]
        alpha_hat = ((1.0 - u) * alpha1 + u * shifted + _EPS) * y1
        alpha1 = alpha_hat / alpha_hat.sum(dim=-1, keepdim=True)
        ctx1 = (alpha1[:, :, None] * mem1).sum(dim=1)
        u_pre = None
        if hp_like["use_ta"]:
            u_pre = torch.cat([ctx1, h_att], dim=-1) @ w["w_ta"] + w["b_ta"]
            u = torch.sigmoid(u_pre)
        alpha2 = torch.softmax(e[..., 1] + score_bias, dim=-1)
        ctx2 = (alpha2[:, :, None] * mem2).sum(dim=1)
        z1 = torch.cat([h_att, ctx1, ctx2, h1], dim=-1) @ w["w_l1"] + w["b_l1"]
        c1, h1 = _zoneout_lstm(
            z1, c1, h1, step_mask(masks[1][0], t), step_mask(masks[1][1], t), fb
        )
        z2 = torch.cat([h1, h2], dim=-1) @ w["w_l2"] + w["b_l2"]
        c2, h2 = _zoneout_lstm(
            z2, c2, h2, step_mask(masks[2][0], t), step_mask(masks[2][1], t), fb
        )
        features.append(h1 + h2)
        aligns.append(torch.cat([alpha1, alpha2], dim=-1))
        if taps is not None:
            taps.append(dict(
                c_att=c_att, h_att=h_att, c1=c1, h1=h1, c2=c2, h2=h2, ctx1=ctx1, ctx2=ctx2,
                alpha=alpha1, u=u, z_att=z_att, z1=z1, z2=z2, qp=qp, y1=y1, alpha2=alpha2,
                x2=x_t, u_pre=u_pre,
            ))
    return torch.stack(features, dim=1), torch.stack(aligns, dim=1)


# --------------------------------------------------------------------------- #
# Operands
# --------------------------------------------------------------------------- #


def _sizes(hp_like: Dict, weights, keys, mem1, mem2, spk, x2) -> Dict[str, int]:
    _require(bool(hp_like.get("dual", True)), "the kernels are dual source")
    _require(hp_like.get("src1_kind", "forward") == "forward",
             "source 1 must use forward attention")
    _require(hp_like.get("io_dtype", "float32") == "float32", "the kernels are float32")
    _require(mem2 is not None, "a second memory is required")
    z = dict(
        P2=int(x2.shape[-1]), SPK=0 if spk is None else int(spk.shape[-1]),
        AU=int(hp_like["att_units"]), A1=int(hp_like["att1_units"]),
        A2=int(hp_like["att2_units"]), DU=int(hp_like["dec_units"]),
        E1=int(mem1.shape[-1]), E2=int(mem2.shape[-1]),
    )
    B, S = mem1.shape[:2]
    A, EW = z["A1"] + z["A2"], z["E1"] + z["E2"]
    expected = {
        "w_attg": (z["P2"] + z["SPK"] + EW + z["AU"], 4 * z["AU"]), "b_attg": (4 * z["AU"],),
        "w_qp": (z["AU"], A), "vblk": (A, 2), "w_ta": (z["E1"] + z["AU"], 1), "b_ta": (1,),
        "w_l1": (z["AU"] + EW + z["DU"], 4 * z["DU"]), "b_l1": (4 * z["DU"],),
        "w_l2": (2 * z["DU"], 4 * z["DU"]), "b_l2": (4 * z["DU"],),
    }
    for name, shape in expected.items():
        _require(tuple(weights[name].shape) == shape,
                 f"{name}: expected shape {shape}, got {tuple(weights[name].shape)}")
    for name, tensor, shape in (
        ("keys", keys, (B, S, A)), ("mem2", mem2, (B, S, z["E2"])),
        ("feeds", x2, (B, x2.shape[1], z["P2"])),
    ):
        _require(tuple(tensor.shape) == shape,
                 f"{name}: expected {shape}, got {tuple(tensor.shape)}")
    _require(z["E1"] % 4 == 0 and z["E2"] % 4 == 0, "memory widths must be multiples of 4")
    _require(z["AU"] + EW != z["DU"], "the first decoder LSTM would take a residual")
    return z


def _pack(z: Dict[str, int], w: Dict[str, torch.Tensor]):
    """The flat weight buffer of the kernels and the offsets of its entries:
    every matrix (in, out), rows padded to 4 floats, transposed copies last."""
    tensors = {
        "attg_w": w["w_attg"], "attg_b": w["b_attg"][None], "qp_w": w["w_qp"],
        "vblk": w["vblk"].t(), "ta_w": w["w_ta"].t(), "ta_b": w["b_ta"][None],
        "l1_w": w["w_l1"], "l1_b": w["b_l1"][None], "l2_w": w["w_l2"], "l2_b": w["b_l2"][None],
        "attg_wt": w["w_attg"].t(), "qp_wt": w["w_qp"].t(),
        "l1_wt": w["w_l1"].t(), "l2_wt": w["w_l2"].t(),
    }
    offsets, total = {}, 0
    for name in _ENTRIES:
        offsets[name] = total
        total += tensors[name].shape[0] * _round4(tensors[name].shape[1])
    ref = w["w_attg"]
    flat = torch.zeros(total, dtype=torch.float32, device=ref.device)
    for name in _ENTRIES:
        t = tensors[name].detach()
        rows, cols = t.shape
        flat[offsets[name] : offsets[name] + rows * _round4(cols)].view(rows, -1)[:, :cols] = t
    return flat, offsets


def _dims(z, B: int, S: int, N: int, use_ta: bool, train_masks: bool, offsets=None):
    # the struct ``Dims`` of the source
    layouts = row_layouts(z, S)
    values = [B, S, N] + [z[k] for k in _SIZES] + [int(use_ta), int(train_masks)]
    values += [layouts[kind][1] for kind in ("carry", "acts", "stack")]
    for kind, names in (("carry", _CARRY), ("acts", _ACTS), ("stack", _STACK)):
        values += [layouts[kind][0][name][0] for name in names]
    values += [0] * len(_ENTRIES) if offsets is None else [offsets[name] for name in _ENTRIES]
    return (ctypes.c_int * len(values))(*values)


def _library():
    lib = load_library("fused_teacher")
    if "fwd" not in _functions:
        for key, name in (("fwd", "fused_teacher_fwd_f32"), ("bwd", "fused_teacher_bwd_f32")):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint), ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _functions[key] = fn
        lib.fused_teacher_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.fused_teacher_smem_bytes.restype = ctypes.c_longlong
        lib.fused_teacher_smem_limit.argtypes = [ctypes.c_int]
        lib.fused_teacher_smem_limit.restype = ctypes.c_longlong
    return lib


def block_shared_memory(z: Dict[str, int], src_len: int, device, backward: bool) -> Tuple[int, int]:
    """(bytes of shared memory one block of the kernel needs, bytes a block may
    have on ``device``), both as the built library reports them."""
    lib = _library()
    with torch.cuda.device(device):
        limit = int(lib.fused_teacher_smem_limit(int(backward)))
    if limit < 0:
        raise RuntimeError(f"fused_teacher: CUDA error {-limit} on reading the device's limits")
    need = int(lib.fused_teacher_smem_bytes(_dims(z, 1, src_len, 1, False, False), int(backward)))
    return need, limit


def _launch(which: str, pointers: Sequence[Optional[torch.Tensor]], dims, hp_like, seed: int,
            device) -> None:
    global launch_count, bwd_launch_count
    zc, zo = float(hp_like["zoneout_cell"]), float(hp_like["zoneout_output"])
    scalars = (ctypes.c_float * 3)(zc, zo, float(hp_like.get("forget_bias", 1.0)))
    bits = (ctypes.c_uint * 9)(
        keep_threshold(zc), keep_threshold(zo), int(seed) & _MASK32, *_draw_numbers(zc, zo)
    )
    array = (ctypes.c_void_p * 18)(*(None if x is None else x.data_ptr() for x in pointers))
    fn = _functions[which]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        err = fn(array, dims, scalars, bits, torch.cuda.current_stream().cuda_stream)
        end.record()
    _launch_events[which] = (start, end)
    if err != 0:
        raise RuntimeError(f"fused_teacher {which} kernel launch failed: CUDA error {err}")
    if which == "fwd":
        launch_count += 1
    else:
        bwd_launch_count += 1


def last_launch_ms(which: str) -> float:
    """Device time in ms of the last launch of the forward (``"fwd"``) or the
    backward (``"bwd"``) kernel, the kernel alone; waits for it to end."""
    start, end = _launch_events[which]
    end.synchronize()
    return start.elapsed_time(end)


# --------------------------------------------------------------------------- #
# Gradients from the backward kernel's rows
# --------------------------------------------------------------------------- #


def grads_from_rows(z, use_ta: bool, x2, spk, aligns, carries, stack, d_brow, d_keys,
                    d_vblk_lanes, d_spk) -> Dict[str, torch.Tensor]:
    """Every gradient of the scanned region from what the backward kernel wrote.

    Weight gradients are one product each over all (B * N) rows: the gradient
    row's cotangent of a product's output against that product's input, rebuilt
    from the carry rows of steps t-1 and t. Bias gradients come from the
    float32 running sum of the gradient rows, the memories' gradients from the
    alignments and the contexts' cotangents, ``vblk``'s from the per-lane partials.
    """
    B, N, _ = x2.shape
    S = d_keys.shape[1]
    layouts = row_layouts(z, S)
    prev = torch.cat([torch.zeros_like(carries[:, :1]), carries[:, :-1]], dim=1)
    cur = lambda name: _col(carries, layouts["carry"], name)   # noqa: E731
    old = lambda name: _col(prev, layouts["carry"], name)      # noqa: E731
    g = lambda name: _col(stack, layouts["stack"], name)       # noqa: E731
    bias = lambda name: _col(d_brow, layouts["stack"], name).sum(dim=0)   # noqa: E731

    def product(inputs: Sequence[torch.Tensor], cotangent: torch.Tensor) -> torch.Tensor:
        x = torch.cat(inputs, dim=-1).reshape(B * N, -1)
        return x.t() @ cotangent.reshape(B * N, -1)

    speaker = [] if spk is None else [spk[:, None, :].expand(B, N, spk.shape[-1])]
    grads = {
        "w_attg": product([x2, *speaker, old("ctx1"), old("ctx2"), old("h_att")], g("g_z_att")),
        "b_attg": bias("g_z_att"),
        "w_qp": product([cur("h_att")], g("g_qp")),
        "vblk": d_vblk_lanes.sum(dim=0).t(),
        "w_l1": product([cur("h_att"), cur("ctx1"), cur("ctx2"), old("h1")], g("g_z1")),
        "b_l1": bias("g_z1"),
        "w_l2": product([cur("h1"), old("h2")], g("g_z2")),
        "b_l2": bias("g_z2"),
        "keys": d_keys,
        "mem1": torch.bmm(aligns[..., :S].transpose(1, 2), g("g_ctx1")),
        "mem2": torch.bmm(aligns[..., S:].transpose(1, 2), g("g_ctx2")),
        "feeds": g("g_feed"),
        "spk": None if spk is None else d_spk,
    }
    if use_ta:
        grads["w_ta"] = product([cur("ctx1"), cur("h_att")], g("g_u_pre"))
        grads["b_ta"] = bias("g_u_pre")
    else:
        grads["w_ta"] = torch.zeros(z["E1"] + z["AU"], 1, dtype=x2.dtype, device=x2.device)
        grads["b_ta"] = torch.zeros(1, dtype=x2.dtype, device=x2.device)
    return grads


class _TeacherCore(torch.autograd.Function):
    """The scanned region on the card: forward and backward each one kernel launch."""

    @staticmethod
    def forward(ctx, hp_like, seed, x2, keys, mem1, mem2, score_bias, spk, *core):
        w = dict(zip(CORE_WEIGHTS, core))
        z = _sizes(hp_like, w, keys, mem1, mem2, spk, x2)
        device = x2.device
        B, N, _ = x2.shape
        S = keys.shape[1]
        _library()
        for backward in (False, True):
            need, have = block_shared_memory(z, S, device, backward)
            if need > have:
                raise RuntimeError(
                    f"fused_teacher cannot launch at src_len={S}: one block of the "
                    f"{'backward' if backward else 'forward'} kernel needs {need} bytes of "
                    f"shared memory, an SM of this device offers {have}"
                )
        operands = [x2, keys, mem1, mem2, score_bias] + ([] if spk is None else [spk])
        for x in operands + list(core):
            if x.dtype != torch.float32 or x.device != device:
                raise TypeError("fused_teacher takes float32 tensors on one CUDA device")
        x2_c, keys_c, mem1_c, mem2_c, bias_c = (x.detach().contiguous() for x in operands[:5])
        spk_c = None if spk is None else spk.detach().contiguous()
        flat, offsets = _pack(z, w)
        train_masks = not hp_like.get("eval_zoneout", False)
        dims = _dims(z, B, S, N, hp_like["use_ta"], train_masks, offsets)
        layouts = row_layouts(z, S)
        f32 = dict(dtype=torch.float32, device=device)
        features = torch.empty(B, N, z["DU"], **f32)
        aligns = torch.empty(B, N, 2 * S, **f32)
        carries = torch.empty(B, N, layouts["carry"][1], **f32)
        acts = torch.empty(B, N, layouts["acts"][1], **f32)
        inputs = [flat, x2_c, keys_c, mem1_c, mem2_c, bias_c, spk_c]
        _launch("fwd", inputs + [features, aligns, carries, acts] + [None] * 7, dims, hp_like,
                seed, device)
        ctx.save_for_backward(*inputs, aligns, carries, acts)
        ctx.meta = (hp_like, seed, z, dims)
        # an output the loss does not read gets no cotangent (None), not a tensor of zeros
        ctx.set_materialize_grads(False)
        return features, aligns

    @staticmethod
    def backward(ctx, g_features, g_aligns):
        flat, x2, keys, mem1, mem2, bias, spk, aligns, carries, acts = ctx.saved_tensors
        hp_like, seed, z, dims = ctx.meta
        device = x2.device
        B, N, _ = x2.shape
        S = keys.shape[1]
        f32 = dict(dtype=torch.float32, device=device)
        stack_width = row_layouts(z, S)["stack"][1]
        if g_features is None:
            g_features = torch.zeros(B, N, z["DU"], **f32)
        g_features = g_features.to(torch.float32).contiguous()
        # the loss does not read the alignments: no cotangent means zeros
        g_aligns = None if g_aligns is None else g_aligns.to(torch.float32).contiguous()
        stack = torch.empty(B, N, stack_width, **f32)
        d_keys = torch.zeros_like(keys)
        d_vblk = torch.empty(B, 2, keys.shape[-1], **f32)
        d_spk = torch.zeros(B, max(z["SPK"], 1), **f32)
        d_brow = torch.zeros(B, stack_width, **f32)
        _launch(
            "bwd",
            [flat, x2, keys, mem1, mem2, bias, spk, None, None, carries, acts,
             g_features, g_aligns, stack, d_keys, d_vblk, d_spk, d_brow],
            dims, hp_like, seed, device,
        )
        g = grads_from_rows(
            z, hp_like["use_ta"], x2, spk, aligns, carries, stack, d_brow, d_keys, d_vblk,
            d_spk[:, : z["SPK"]],
        )
        return (None, None, g["feeds"], g["keys"], g["mem1"], g["mem2"], None, g["spk"],
                *(g[name] for name in CORE_WEIGHTS))


# --------------------------------------------------------------------------- #
# The wrapper
# --------------------------------------------------------------------------- #


def _decode(core, *, weights, keys, mem1, mem2, score_bias, spk, feeds, seed, hp_like,
            prenet_masks, generator):
    _require(feeds.dim() == 3, f"feeds must be (B, N, F), got {tuple(feeds.shape)}")
    x2 = _prenet(weights, feeds, float(hp_like["prenet_drop_rate"]), prenet_masks, generator)
    return core(hp_like, int(seed), x2, keys, mem1, mem2, score_bias, spk)


def teacher_decode_reference(*, weights, keys, mem1, mem2, score_bias, spk, feeds, seed,
                             hp_like, prenet_masks=None, generator=None):
    """Plain PyTorch version of ``teacher_decode``: the same function step by
    step, differentiable by autograd, with the same zoneout masks."""
    def core(hp_like, seed, x2, keys, mem1, mem2, score_bias, spk):
        _sizes(hp_like, weights, keys, mem1, mem2, spk, x2)
        return _core_plain(hp_like, weights, x2, keys, mem1, mem2, score_bias, spk, seed)

    return _decode(core, weights=weights, keys=keys, mem1=mem1, mem2=mem2,
                   score_bias=score_bias, spk=spk, feeds=feeds, seed=seed, hp_like=hp_like,
                   prenet_masks=prenet_masks, generator=generator)


def teacher_decode(*, weights, keys, mem1, mem2, score_bias, spk, feeds, seed, hp_like,
                   prenet_masks=None, generator=None):
    """Differentiable teacher-forced decode: ``(features (B, N, DU), alignments (B, N, 2S))``.

    ``weights``: every matrix (in, out): the prenet's ``w_p1, b_p1, w_p2, b_p2``
    and ``CORE_WEIGHTS`` (``vblk`` (A1 + A2, 2) holds each mechanism's score
    vector in its own column and rows, ``w_qp`` is the fused query projection).
    ``keys`` (B, S, A1 + A2) are both mechanisms' keys side by side,
    ``score_bias`` (B, S) is 0 where valid and -1e9 where padded, ``feeds``
    (B, N, F) the teacher frames, ``seed`` the zoneout masks' seed. ``hp_like``:
    ``use_ta, att_units, att1_units, att2_units, dec_units, zoneout_cell,
    zoneout_output, prenet_drop_rate, eval_zoneout``.

    Tensors on a CUDA device go to the two kernels or raise; on the CPU they go
    to ``teacher_decode_reference``.
    """
    device = feeds.device
    if device.type == "cpu":
        return teacher_decode_reference(
            weights=weights, keys=keys, mem1=mem1, mem2=mem2, score_bias=score_bias, spk=spk,
            feeds=feeds, seed=seed, hp_like=hp_like, prenet_masks=prenet_masks,
            generator=generator,
        )
    if device.type != "cuda":
        raise RuntimeError(f"fused_teacher has no kernel for device {device}")

    def core(hp_like, seed, x2, keys, mem1, mem2, score_bias, spk):
        return _TeacherCore.apply(
            hp_like, seed, x2, keys, mem1, mem2, score_bias, spk,
            *(weights[name] for name in CORE_WEIGHTS),
        )

    return _decode(core, weights=weights, keys=keys, mem1=mem1, mem2=mem2,
                   score_bias=score_bias, spk=spk, feeds=feeds, seed=seed, hp_like=hp_like,
                   prenet_masks=prenet_masks, generator=generator)
