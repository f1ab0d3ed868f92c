"""The whole autoregressive decode loop in one launch: CUDA kernel, plain version, wrapper.

``fused_decode`` replaces ``fused_decode`` of the JAX package
(``self_attention_tacotron_tpu/ops/fused_decode.py``, ``_make_kernel`` /
``_run_fused``): every decoder step of a synthesis request (prenet with its
always-on dropout, attention ZoneoutLSTM, the query projection, the additive
scores, the forward-attention recursion with or without the transition agent,
contexts, two decoder ZoneoutLSTMs, the causal self-attention block over a
growing K/V cache where the decoder has one, the output projection, per-lane
stop tracking and the early exit) runs inside one kernel
(``csrc/fused_decode.cu``), with no host work per step.

What bounds it on an H100: the serial chain of a step's dependent stages. A step
needs about 2 * 3.5 M * B operations and 14 MB of float32 weights (7 MB in
bfloat16), far below what the card can do in the time one step's 15 dependent
stages (the flagship's) take. The design spreads every stage over the whole card:
one block per SM, all resident at once (a cooperative launch), each holding its
slice of every decoder matrix and its biases in shared memory for the whole
launch (whole output columns; an LSTM's four gate columns of a unit together),
dealt out by ``grid_plan``; a stage copies its input rows into shared memory with
the Tensor Memory Accelerator, and the blocks meet at a grid-wide barrier between
the dependent stages of a step; every block takes the exit decision from the same
stop probabilities. The attention's scores go to a warp per (lane, 2 positions;
8 with location-sensitive attention), its softmaxes, alignments and contexts to a
block per (lane, 128 context
columns), which keeps the rows' first ``ATT_TILE`` source positions in shared memory
and walks a longer source in tiles of as many, the decoder self-attention to a
block per (lane, head), walking the cache's prefix in tiles of ``SA_TILE`` positions
with an online softmax, so one block's shared memory grows neither with the source
length nor with ``max_iters``; where it outgrows an SM (weights too wide for the
card) the wrapper raises. One launch takes up to
``MAX_LANES`` lanes; larger batches run as sequential batch blocks.
``stage_times`` reads the time of each stage of a step from stamps the kernel
writes.

``compute_dtype="bfloat16"`` runs the kernel's bfloat16 branch: the weights,
keys, memories, speaker embedding and K/V cache are bfloat16 (the score
vectors and LayerNorm parameters stay float32, as the JAX package packs them),
the input of every product is rounded to bfloat16 where the Pallas kernel
casts it to its io dtype, and sums, state, softmaxes and outputs stay float32.

The prenet's dropout masks come in as arrays, one row per step, drawn by the
caller: the kernel and the step-by-step path of ``ops/decode_loop.py`` are then
the same function of the same generator.

Specialised to the four decoders, compiled once for each pair of flags
``dual`` (a second source with additive attention, queried through the fused
projection; else the mechanism's own query layer) and ``use_sa`` (one decoder
self-attention hop; else the output projection reads the feature), and for
each io type, float32 and bfloat16: forward attention (with or without
transition agent) on source 1, optional speaker embedding, the mel head or the
WORLD heads of the ``MgcLf0`` decoders, ``n_feed_frame=1``, two prenet layers.
The kernel sees a frame as one ``M``-wide row; with the WORLD heads its lanes
from ``LF0`` (``num_mgcs``) on are the lf0 class logits, which it softmaxes, in
float32 and from the unrounded logits, before they feed the next step's prenet
(training feeds one-hot rows there); the frames it returns stay logits. That
feedback (``LF0 > 0``) and location-sensitive attention on source 1 (``K > 0``) are
compiled for all four pairs of flags, each without and with the other, in both io
types. Location-sensitive attention takes an odd number of taps up to
``MAX_TAPS``: its convolution and dense layer come folded
into one map of the taps (``models/attention.py::location_fold``), the
alignments are the softmax itself, start uniform, and the taps read the
cumulative alignments or the previous ones.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from self_attention_tacotron_torch.models.attention import (
    AdditiveAttention,
    ForwardAttention,
    LocationSensitiveAttention,
    location_fold,
)
from self_attention_tacotron_torch.models.decoders import (
    DECODERS,
    MGC_LF0,
    Decoder,
    DecoderConditioning,
    base_decoder,
)
from self_attention_tacotron_torch.models.encoders import encoder_out_units
from self_attention_tacotron_torch.models.models import COMPUTE_DTYPES
from self_attention_tacotron_torch.ops.decode_loop import DecodeResult
from self_attention_tacotron_torch.ops.fused_teacher import MAX_TAPS, location_taps, taps_supported
from self_attention_tacotron_torch.ops.grid import SLICE_BYTES, deal  # noqa: F401
from self_attention_tacotron_torch.ops.grid import round8 as _round8
from self_attention_tacotron_torch.utils.cuda_build import load_library

# Launches of the CUDA kernel made by ``fused_decode`` in this process.
launch_count = 0
# Launches per specialisation, keyed by ``variant_name``.
variant_launches: Dict[str, int] = {}

# Most lanes one launch takes, as csrc/fused_decode.cu has it (MAX_LANES).
MAX_LANES = 1024
# Multiprocessors of an H100 SXM: the grid planned where no card is present.
H100_SM_COUNT = 132
# Shared memory one block of an H100 may opt in to, in bytes, and at most what the
# kernel declares statically besides (its few shared scalars).
H100_BLOCK_SMEM = 232448
STATIC_SMEM = 64
# Threads of a block, as csrc/fused_decode.cu has it, and room for the stamps of a step
# (1 + 3 a stage).
_NT = 512
_STAMP_SLOTS = 64
# The location taps' rows as the kernel holds them (location.cuh: LS_TAPS), the
# context columns one block of the alignment stage takes (CTX_COLS) and the source
# positions of its tiles (ATT_TILE).
_LS_TAPS = 32
_CTX_COLS = 128
_ATT_TILE = 512
# Positions of the decoder self-attention's prefix per tile, as csrc/fused_decode.cu
# has it: requests of up to this many steps attend in one tile.
SA_TILE = 512

_NEG_INF = -1e9
_EPS = 1e-6

_function = None


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


# --------------------------------------------------------------------------- #
# Which configurations the kernel serves
# --------------------------------------------------------------------------- #


def variant_name(dual: bool, use_sa: bool, io_dtype=torch.float32, ls: bool = False,
                 lf0: bool = False) -> str:
    """The name of a specialisation of the kernel, as ``variant_launches`` keys it."""
    name = f"dual={int(dual)},use_sa={int(use_sa)}" + (",ls" if ls else "") + (
        ",lf0" if lf0 else "")
    return name if io_dtype == torch.float32 else f"{name},bf16"


def supports_fused_decode(hp) -> bool:
    """True for the family that the kernel is specialised to.

    The four decoders (one or two sources, with or without one decoder
    self-attention hop), with the mel head or, under the ``MgcLf0`` prefix, the
    mgc and lf0 heads, forward attention with or without the transition agent
    on source 1, additive attention on source 2 where there is one,
    ``n_feed_frame=1``, two prenet layers, float32 or bfloat16; or location-sensitive
    attention on source 1 with an odd ``attention_kernel`` up to ``MAX_TAPS``, on
    every decoder and with either head, as the JAX package's kernel serves it. The
    kernel reads memories and cache rows four values at a time, so those widths are
    multiples of 4; and the first decoder LSTM has no residual, which holds whenever
    its input and output widths differ (the JAX kernel drops that residual:
    ``ROADMAP.md`` §3).
    """
    base = base_decoder(hp.decoder)
    if base not in DECODERS:
        return False
    sources, use_sa = DECODERS[base]
    z = _hp_sizes(hp)
    sa_ok = not use_sa or (
        hp.decoder_self_attention_num_hop == 1
        and z["SA"] % z["H"] == 0
        and (z["SA"] // z["H"]) % 4 == 0
    )
    mechanism_ok = hp.attention in ("forward", "forward_transition_agent") or (
        hp.attention == "location_sensitive"
        and taps_supported(hp.attention_kernel)
    )
    return bool(
        mechanism_ok
        and (sources == 1 or hp.attention2 == "additive")
        and sa_ok
        and hp.n_feed_frame == 1
        and len(hp.decoder_prenet_out_units) == 2
        and not hp.use_forced_alignment_mode
        and hp.compute_dtype in COMPUTE_DTYPES
        and z["E1"] % 4 == 0
        and z["E2"] % 4 == 0
        and z["AU"] + z["E1"] + z["E2"] != z["DU"]
    )


def _hp_sizes(hp) -> Dict[str, int]:
    # FFN: ``decoder_factory`` leaves the block's feed-forward width at its default
    sources, use_sa = DECODERS[base_decoder(hp.decoder)]
    dual = sources == 2
    mgc_lf0 = hp.decoder.startswith(MGC_LF0)
    return dict(
        M=hp.num_mgcs + hp.num_lf0s if mgc_lf0 else hp.num_mels, R=hp.outputs_per_step,
        P1=hp.decoder_prenet_out_units[0], P2=hp.decoder_prenet_out_units[1],
        SPK=hp.speaker_embedding_dim if hp.use_speaker_embedding else 0,
        AU=hp.attention_out_units, A1=hp.attention1_out_units,
        A2=hp.attention2_out_units if dual else 0, DU=hp.decoder_out_units,
        SA=hp.decoder_self_attention_out_units if use_sa else 0,
        H=hp.decoder_self_attention_num_heads if use_sa else 0, FFN=1024 if use_sa else 0,
        E1=encoder_out_units(hp), E2=hp.self_attention_out_units if dual else 0,
        K=hp.attention_kernel if hp.attention == "location_sensitive" else 0,
        LF0=hp.num_mgcs if mgc_lf0 else 0,
    )


def fused_decode_max_batch(hp) -> int:
    """Most lanes one launch takes; 0 when the configuration cannot run fused at all.

    The kernel's grid is one block per SM, and a launch takes up to ``MAX_LANES``
    lanes whenever one block's shared memory (its slice of the weights and the rows
    of its stages, which grow neither with the source length nor with ``max_iters``)
    fits an SM; else nothing can be launched. On a card the built kernel is asked,
    on the card's SM count; without one ``grid_plan`` answers for an H100.
    """
    if not supports_fused_decode(hp):
        return 0
    io = COMPUTE_DTYPES[hp.compute_dtype]
    if not torch.cuda.is_available():
        return grid_plan(_hp_sizes(hp), H100_SM_COUNT, io).max_lanes
    device = torch.device("cuda", torch.cuda.current_device())
    return _launch_limit(_hp_sizes(hp), device, io)


# --------------------------------------------------------------------------- #
# The grid plan (csrc/fused_decode.cu: product_shape, plan_block, smem_layout)
# --------------------------------------------------------------------------- #

# The products of a step in the order they run, as the kernel's ``Product`` enum.
PRODUCTS = ("p1", "p2", "attg", "qp", "l1", "l2", "in", "qkv", "o", "f1", "f2", "out")
# The stages of a step, each ending at a grid barrier (the self-attention block's
# only where the decoder has one).
STAGES = ("p1", "p2", "attg", "qp", "scores", "attention", "l1", "l2", "in", "qkv",
          "self_attention", "o", "f1", "f2", "out")
_SA_STAGES = ("in", "qkv", "self_attention", "o", "f1", "f2")


def stages(use_sa: bool) -> Tuple[str, ...]:
    """The stages of one step of a specialisation, in order."""
    return STAGES if use_sa else tuple(s for s in STAGES if s not in _SA_STAGES)


def product_shapes(sizes: Dict[str, int]) -> Dict[str, Tuple[int, int, bool]]:
    """{product: (K, items, gates)}: the depth of each product and its items, output
    columns or, where ``gates``, LSTM units of four gate columns each; a product the
    specialisation does not have has no items."""
    z = sizes
    ew, sa = z["E1"] + z["E2"], z["SA"] > 0
    return {
        "p1": (z["M"], z["P1"], False),
        "p2": (z["P1"], z["P2"], False),
        "attg": (z["P2"] + z["SPK"] + ew + z["AU"], z["AU"], True),
        "qp": (z["AU"], z["A1"] + z["A2"], False),
        "l1": (z["AU"] + ew + z["DU"], z["DU"], True),
        "l2": (2 * z["DU"], z["DU"], True),
        "in": (z["DU"], z["SA"] if sa else 0, False),
        "qkv": (z["SA"], 3 * z["SA"], False),
        "o": (z["SA"], z["SA"], False),
        "f1": (z["SA"], z["FFN"] if sa else 0, False),
        "f2": (z["FFN"], z["SA"], False),
        "out": (z["SA"] if sa else z["DU"], z["R"] * z["M"] + z["R"], False),
    }


@dataclasses.dataclass
class GridPlan:
    """Which block of a grid owns what, and the shared memory that asks for.

    ``blocks[product]``: the blocks its items are dealt to (as few as give each at
    least 8 columns, or 2 units of a gate product, while a block's slice of it stays
    within ``SLICE_BYTES``). ``slices[b][product] = (first, count, columns)``: block
    ``b`` owns items ``first .. first + count - 1`` of the product and holds their
    columns (of a gate product ``i, g, f, o`` of each unit) and biases in shared
    memory for the whole launch. ``weight_bytes[b]`` is its weight region;
    ``smem_bytes`` what one block needs at the least (the largest weight region and
    bias region, the LayerNorm parameters, the location matrix, every lane's flags
    and the smallest room of the stages); ``max_lanes`` the most lanes one launch
    takes (0 where a block does not fit ``H100_BLOCK_SMEM``).
    """

    n_blocks: int
    blocks: Dict[str, int]
    slices: Tuple[Dict[str, Tuple[int, int, int]], ...]
    weight_bytes: Tuple[int, ...]
    smem_bytes: int
    max_lanes: int

    def columns(self, product: str, sizes: Dict[str, int]) -> Tuple[int, ...]:
        """The product's output columns in the order the blocks hold them."""
        _, items, gates = product_shapes(sizes)[product]
        cols = []
        for per_block in self.slices:
            first, count, _ = per_block[product]
            for unit in range(first, first + count):
                cols += [g * items + unit for g in range(4)] if gates else [unit]
        return tuple(cols)


def grid_plan(sizes: Dict[str, int], n_sms: int, io_dtype=torch.float32) -> GridPlan:
    """The kernel's plan on a grid of ``n_sms`` blocks, as it computes it itself."""
    shapes = product_shapes(sizes)
    io = 2 if io_dtype == torch.bfloat16 else 4
    # a row or weight column in shared memory: the stride of the rows in global memory
    ldk = _round8
    blocks, slices, weights, biases = deal({name: shapes[name] for name in PRODUCTS}, n_sms,
                                           io, biases=True)
    z = sizes
    widest = max(ldk(K) for K, items, _ in shapes.values() if items > 0)
    staged = _round4(max(z["M"], z["SA"]))   # a LayerNorm's or the fed-back frame's float row
    hd = z["SA"] // z["H"] if z["SA"] else 0
    lane_rows = 6 * _ATT_TILE + max(4 * _NT, _CTX_COLS)
    sa_rows = 2 * _round4(hd) + SA_TILE + max(4 * _NT, _round4(hd)) if z["SA"] else 0
    work = max(4 * (widest * io + 4 * staged), 4 * max(lane_rows, sa_rows))
    # the biases and LayerNorm parameters, every lane's finished flag, length and end
    # of the valid source
    fixed = (max(weights) + max(biases) + 4 * _round4(z["SA"]) * 4
             + (_LS_TAPS * _round4(z["A1"]) * 4 if z["K"] else 0) + 3 * _round4(MAX_LANES) * 4)
    smem = fixed + work
    return GridPlan(n_blocks=n_sms, blocks=blocks, slices=tuple(slices),
                    weight_bytes=tuple(weights),
                    smem_bytes=smem,
                    max_lanes=MAX_LANES if smem + STATIC_SMEM <= H100_BLOCK_SMEM else 0)


# --------------------------------------------------------------------------- #
# Operand packing
# --------------------------------------------------------------------------- #

# Order of the matrices and vectors in the flat weight buffers; the enum
# ``Entry`` of the source lists the same names in the same order.
_ENTRIES = (
    "p1_w", "p1_b", "p2_w", "p2_b", "attg_w", "attg_b", "qp_w", "v_cat", "ta_w", "ta_b",
    "l1_w", "l1_b", "l2_w", "l2_b", "in_w", "in_b", "ln1_s", "ln1_b", "ln2_s", "ln2_b",
    "qkv_w", "o_w", "o_b", "f1_w", "f1_b", "f2_w", "f2_b", "out_w", "out_b", "ls_w", "ls_b",
)
# The entries that stay float32 whatever the io type (the JAX package packs them
# so): the score vectors, the LayerNorm parameters and the location bias. They
# have their own buffer.
_F32_ENTRIES = ("v_cat", "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ls_b")
# Order of the sizes handed to the kernel, before the offsets of the entries. They
# name the specialisation: ``E2 > 0`` two sources, ``SA > 0`` decoder self-attention,
# ``K > 0`` (the location taps) location-sensitive attention, ``LF0 > 0`` (the first
# lf0 lane of a frame; 0 for the mel head) the lf0 feedback.
_SIZES = (
    "M", "R", "P1", "P2", "SPK", "AU", "A1", "A2", "DU", "SA", "H", "FFN", "E1", "E2", "K", "LF0",
)
# The frame layouts the kernel serves: the mel head, or the WORLD heads mgc and lf0.
_HEAD_NAMES = (("mel",), ("mgc", "lf0"))
# The entries of the self-attention block: empty without it.
_SA_ENTRIES = (
    "in_w", "in_b", "ln1_s", "ln1_b", "ln2_s", "ln2_b",
    "qkv_w", "o_w", "o_b", "f1_w", "f1_b", "f2_w", "f2_b",
)
# The folded location taps (``MAX_TAPS`` rows, zero beyond K) and their bias: empty
# without location-sensitive attention.
_LS_ENTRIES = ("ls_w", "ls_b")


@dataclasses.dataclass
class PackedDecoder:
    """A decoder's weights in the kernel's layout.

    ``flat`` holds every matrix as (in, out), what the plain version multiplies
    by, in the io type (float32 or bfloat16: the decoder's compute dtype), each
    row padded to a multiple of 4 values and each entry starting at a multiple of
    4 values, so that the kernel reads four values at a time. ``flat32`` holds the
    entries of ``_F32_ENTRIES`` the same way in float32. ``mat(name)`` is the
    (rows, cols) view of one entry, without the padding; an entry the
    specialisation does not have is (0, 0). ``dual``, ``use_sa`` and ``ls`` name
    the specialisation, read from the widths; ``ls_cumulative``: the location taps
    read the cumulative alignments; ``heads``: the decoder's ((head, width), ...),
    whose widths add up to ``M``.
    """

    flat: torch.Tensor
    offsets: Dict[str, int]
    shapes: Dict[str, Tuple[int, int]]
    sizes: Dict[str, int]
    use_transition_agent: bool
    zoneout_cell: float
    zoneout_output: float
    forget_bias: float
    keep_prob: float
    ln_eps: float
    pe_rate: torch.Tensor   # (SA,) float64 sinusoid rates; empty without self-attention
    flat32: Optional[torch.Tensor] = None
    ls_cumulative: bool = False
    heads: Tuple[Tuple[str, int], ...] = (("mel", 80),)

    @property
    def dual(self) -> bool:
        return self.sizes["E2"] > 0

    @property
    def use_sa(self) -> bool:
        return self.sizes["SA"] > 0

    @property
    def ls(self) -> bool:
        return self.sizes["K"] > 0

    @property
    def lf0(self) -> bool:
        return self.sizes["LF0"] > 0

    @property
    def io_dtype(self) -> torch.dtype:
        return self.flat.dtype

    def mat(self, name: str) -> torch.Tensor:
        rows, cols = self.shapes[name]
        start = self.offsets[name]
        buffer = self.flat32 if name in _F32_ENTRIES else self.flat
        return buffer[start : start + rows * _round4(cols)].view(rows, _round4(cols))[:, :cols]

    def vec(self, name: str) -> torch.Tensor:
        return self.mat(name)[0]


def _require(condition: bool, message: str) -> None:
    if not condition:
        raise ValueError(f"fused_decode: {message}")


def pack_decoder(decoder: Decoder) -> PackedDecoder:
    """Bring the weights of ``decoder`` into the kernel's layout, on their device,
    in the decoder's compute dtype (rounded from its float32 parameters, as the
    JAX package casts every packed weight).

    Raises ``ValueError`` for a decoder outside the kernel's specialisations.
    """
    dual = decoder.num_attentions == 2
    mech1 = decoder.attentions[0]
    ls = isinstance(mech1, LocationSensitiveAttention)
    _require(decoder.num_attentions in (1, 2), "the kernel takes one or two sources")
    _require(isinstance(mech1, ForwardAttention) or ls,
             "source 1 must use forward or location-sensitive attention")
    if dual:
        mech2 = decoder.attentions[1]
        _require(isinstance(mech2, AdditiveAttention), "source 2 must use additive attention")
        _require(decoder.query_projection is not None, "no fused query projection")
    else:
        _require(mech1.query_layer is not None, "the mechanism has no query layer")
    _require(decoder.n_feed_frame == 1, "n_feed_frame must be 1")
    _require(len(decoder.prenet.out_units) == 2, "the prenet must have two layers")
    _require(decoder.num_decoder_layers == 2, "the decoder must have two LSTM layers")
    heads = decoder.output_heads
    _require(tuple(h for h, _ in heads) in _HEAD_NAMES,
             "the kernel serves the mel head or the mgc and lf0 heads")
    sa = decoder.self_attention
    use_sa = sa is not None
    _require(not use_sa or (sa.num_hop == 1 and sa.use_positional_encoding),
             "one decoder self-attention hop with positional encoding is required")
    if ls:
        _require(taps_supported(mech1.attention_kernel),
                 f"the location convolution needs an odd number of taps up to {MAX_TAPS}")
    cells = (decoder.attention_lstm, *decoder.decoder_lstms)
    for attr in ("zoneout_factor_cell", "zoneout_factor_output", "forget_bias"):
        _require(len({getattr(c, attr) for c in cells}) == 1, f"the cells differ in {attr}")
    _require(not decoder.training, "the kernel computes eval-mode zoneout: call .eval()")

    E1 = decoder.memory_units[0]
    E2 = decoder.memory_units[1] if dual else 0
    P1, P2 = decoder.prenet.out_units
    AU, DU = decoder.attention_rnn_out_units, decoder.decoder_out_units
    block = sa.block_0 if use_sa else None
    SA, H = (sa.num_units, block.mha.num_heads) if use_sa else (0, 0)
    KA = decoder.attention_lstm.gates.in_features
    sizes = dict(
        M=decoder.out_dim, R=decoder.outputs_per_step, P1=P1, P2=P2,
        SPK=KA - (P2 + E1 + E2 + AU), AU=AU, A1=mech1.num_units,
        A2=decoder.attentions[1].num_units if dual else 0, DU=DU, SA=SA, H=H,
        FFN=block.ffn1.out_features if use_sa else 0, E1=E1, E2=E2,
        K=mech1.attention_kernel if ls else 0,
        LF0=heads[0][1] if heads[-1][0] == "lf0" else 0,
    )
    _require(sizes["SPK"] >= 0, "the attention LSTM is narrower than its inputs")
    _require(E1 % 4 == 0 and E2 % 4 == 0, "memory widths must be multiples of 4")
    _require(not use_sa or (SA % H == 0 and (SA // H) % 4 == 0),
             "head width must be a multiple of 4")
    _require(AU + E1 + E2 != DU, "the first decoder LSTM would take a residual")
    _require(decoder.decoder_lstm_1.gates.in_features == 2 * DU, "second LSTM input width")

    def t(linear) -> torch.Tensor:
        return linear.weight.detach().t()

    def row(vector) -> torch.Tensor:
        return vector.detach().reshape(1, -1)

    use_ta = getattr(mech1, "transition_factor", None) is not None
    ref = decoder.output_projection.weight
    zeros = lambda *shape: torch.zeros(*shape, dtype=ref.dtype, device=ref.device)  # noqa: E731
    tensors = {
        "p1_w": t(decoder.prenet.Dense_0), "p1_b": row(decoder.prenet.Dense_0.bias),
        "p2_w": t(decoder.prenet.Dense_1), "p2_b": row(decoder.prenet.Dense_1.bias),
        "attg_w": t(decoder.attention_lstm.gates), "attg_b": row(decoder.attention_lstm.gates.bias),
        # dual: both mechanisms' query projections as one product; one source: its own
        "qp_w": t(decoder.query_projection) if dual else t(mech1.query_layer),
        "v_cat": torch.cat([row(m.attention_v) for m in decoder.attentions], dim=1),
        # [context | query], as the mechanism concatenates them
        "ta_w": row(mech1.transition_factor.weight) if use_ta else zeros(1, E1 + AU),
        "ta_b": row(mech1.transition_factor.bias) if use_ta else zeros(1, 1),
        "l1_w": t(decoder.decoder_lstm_0.gates), "l1_b": row(decoder.decoder_lstm_0.gates.bias),
        "l2_w": t(decoder.decoder_lstm_1.gates), "l2_b": row(decoder.decoder_lstm_1.gates.bias),
        "out_w": t(decoder.output_projection), "out_b": row(decoder.output_projection.bias),
    }
    if use_sa:
        tensors.update({
            "in_w": t(sa.in_proj), "in_b": row(sa.in_proj.bias),
            "ln1_s": row(block.ln1.weight), "ln1_b": row(block.ln1.bias),
            "ln2_s": row(block.ln2.weight), "ln2_b": row(block.ln2.bias),
            "qkv_w": t(block.mha.qkv),
            "o_w": t(block.mha.out), "o_b": row(block.mha.out.bias),
            "f1_w": t(block.ffn1), "f1_b": row(block.ffn1.bias),
            "f2_w": t(block.ffn2), "f2_b": row(block.ffn2.bias),
        })
    else:
        tensors.update({name: zeros(0, 0) for name in _SA_ENTRIES})
    if ls:
        with torch.no_grad():
            w_ls, b_ls = location_fold(mech1)
        tensors["ls_w"] = torch.nn.functional.pad(w_ls, (0, 0, 0, MAX_TAPS - sizes["K"]))
        tensors["ls_b"] = row(b_ls)
    else:
        tensors.update({name: zeros(0, 0) for name in _LS_ENTRIES})
    A, OW = sizes["A1"] + sizes["A2"], sizes["R"] * sizes["M"] + sizes["R"]
    expected = {
        "p1_w": (sizes["M"], P1), "p2_w": (P1, P2), "attg_w": (KA, 4 * AU), "qp_w": (AU, A),
        "v_cat": (1, A), "ta_w": (1, E1 + AU), "l1_w": (AU + E1 + E2 + DU, 4 * DU),
        "l2_w": (2 * DU, 4 * DU), "out_w": (SA if use_sa else DU, OW),
    }
    if use_sa:
        expected.update({
            "in_w": (DU, SA), "qkv_w": (SA, 3 * SA), "o_w": (SA, SA),
            "f1_w": (SA, sizes["FFN"]), "f2_w": (sizes["FFN"], SA),
        })
    if ls:
        expected.update({"ls_w": (MAX_TAPS, sizes["A1"]), "ls_b": (1, sizes["A1"])})
    io = decoder.compute_dtype
    _require(io in COMPUTE_DTYPES.values(),
             f"compute dtype {io}: the kernel takes float32 or bfloat16")
    offsets, shapes, totals = {}, {}, {False: 0, True: 0}
    for name in _ENTRIES:
        w = tensors[name]
        _require(w.dtype == torch.float32, f"{name} is {w.dtype}, the parameters are float32")
        _require(w.device == ref.device, f"{name} is on {w.device}, not on {ref.device}")
        if name in expected:
            _require(tuple(w.shape) == expected[name],
                     f"{name}: expected shape {expected[name]}, got {tuple(w.shape)}")
        in_f32 = name in _F32_ENTRIES
        offsets[name], shapes[name] = totals[in_f32], tuple(w.shape)
        totals[in_f32] += w.shape[0] * _round4(w.shape[1])
    packed = PackedDecoder(
        flat=torch.zeros(totals[False], dtype=io, device=ref.device),
        offsets=offsets, shapes=shapes, sizes=sizes, use_transition_agent=use_ta,
        zoneout_cell=float(cells[0].zoneout_factor_cell),
        zoneout_output=float(cells[0].zoneout_factor_output),
        forget_bias=float(cells[0].forget_bias),
        keep_prob=1.0 - float(decoder.prenet.drop_rate),
        ln_eps=float(block.ln1.eps) if use_sa else 0.0,
        pe_rate=_pe_rate(SA, ref.device),
        flat32=torch.zeros(max(totals[True], 4), dtype=torch.float32, device=ref.device),
        ls_cumulative=ls and bool(mech1.cumulative_weights),
        heads=tuple(heads),
    )
    for name in _ENTRIES:
        packed.mat(name).copy_(tensors[name])
    return packed


def _pe_rate(dim: int, device) -> torch.Tensor:
    # the rates of models/self_attention.py::_sinusoid_table, kept in float64
    i = torch.arange(dim, dtype=torch.float64)
    rate = 1.0 / torch.pow(torch.tensor(10000.0, dtype=torch.float64),
                           2.0 * torch.div(i, 2, rounding_mode="floor") / dim)
    return rate.to(device)


@dataclasses.dataclass
class _Operands:
    """Conditioning and masks as both the kernel and the plain version read them;
    keys, memories and speaker embedding in the io type."""

    keys_cat: torch.Tensor      # (B, S, A1 + A2)
    score_bias: torch.Tensor    # (B, S) float32: 0 where valid, -1e9 where padded
    mem1: torch.Tensor          # (B, S, E1)
    mem2: Optional[torch.Tensor]  # (B, S, E2), None with one source
    spk: Optional[torch.Tensor]  # (B, SPK) or None
    masks: Optional[Tuple[torch.Tensor, torch.Tensor]]   # (T, B, P1), (T, B, P2) bool


def _operands(packed: PackedDecoder, cond: DecoderConditioning, prenet_masks,
              max_iters: int) -> _Operands:
    z = packed.sizes
    device, io = packed.flat.device, packed.io_dtype
    n = 2 if packed.dual else 1
    _require(len(cond.memories) == n and len(cond.keys) == n,
             f"{n} attention source(s) expected")
    B, S, _ = cond.memories[0].shape
    _require(B >= 1 and S >= 1 and max_iters >= 1, "empty batch, source or step count")
    checks = [("memories[0]", cond.memories[0], (B, S, z["E1"])),
              ("keys[0]", cond.keys[0], (B, S, z["A1"]))]
    if packed.dual:
        checks += [("memories[1]", cond.memories[1], (B, S, z["E2"])),
                   ("keys[1]", cond.keys[1], (B, S, z["A2"]))]
    for name, tensor, shape in checks:
        _require(tuple(tensor.shape) == shape,
                 f"{name}: expected {shape}, got {tuple(tensor.shape)}")
        _require(tensor.dtype in COMPUTE_DTYPES.values(),
                 f"{name} is {tensor.dtype}, not float32 or bfloat16")
        _require(tensor.device == device, f"{name} is on {tensor.device}, the weights on {device}")
    # in the io type, as the JAX package casts them
    mem1 = cond.memories[0].detach().to(io).contiguous()
    mem2 = cond.memories[1].detach().to(io).contiguous() if packed.dual else None
    keys_cat = torch.cat([k.detach().to(io) for k in cond.keys], dim=-1).contiguous()
    mask = cond.masks[0]
    if mask is None:
        score_bias = torch.zeros(B, S, dtype=torch.float32, device=device)
    else:
        _require(tuple(mask.shape) == (B, S) and mask.dtype == torch.bool,
                 "masks[0] must be a (B, S) boolean mask")
        score_bias = torch.where(mask.to(device), 0.0, _NEG_INF).to(torch.float32)
    spk = cond.speaker_embed
    if z["SPK"]:
        _require(spk is not None and tuple(spk.shape) == (B, z["SPK"]),
                 f"a (B, {z['SPK']}) speaker embedding is required")
        spk = spk.detach().to(device=device, dtype=io).contiguous()
    else:
        _require(spk is None, "the decoder takes no speaker embedding")
    masks = None
    if prenet_masks is not None:
        _require(len(prenet_masks) == 2, "one mask array per prenet layer")
        masks = []
        for m, units in zip(prenet_masks, (z["P1"], z["P2"])):
            m = torch.as_tensor(m).to(device=device, dtype=torch.bool)
            _require(m.dim() == 3 and m.shape[0] >= max_iters and tuple(m.shape[1:]) == (B, units),
                     f"prenet mask: expected (>= {max_iters}, {B}, {units}), got {tuple(m.shape)}")
            masks.append(m[:max_iters].contiguous())
        masks = tuple(masks)
    else:
        _require(packed.keep_prob >= 1.0, "prenet dropout is on: hand in the masks")
    return _Operands(keys_cat, score_bias.contiguous(), mem1, mem2, spk, masks)


# --------------------------------------------------------------------------- #
# The plain PyTorch version
# --------------------------------------------------------------------------- #


def _lstm(x_h, w, b, c, h, p: PackedDecoder):
    i, g, f, o = (x_h @ w + b).chunk(4, dim=-1)
    new_c = torch.sigmoid(f + p.forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    zc, zo = p.zoneout_cell, p.zoneout_output
    return zc * c + (1.0 - zc) * new_c, zo * h + (1.0 - zo) * new_h


def _layer_norm(x, scale, bias, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    centred = x - mean
    var = (centred * centred).mean(dim=-1, keepdim=True)
    return centred / torch.sqrt(var + eps) * scale + bias


def _attend(q, k_cache, v_cache, n: int, H: int, tile: int):
    """softmax(q . K[0..n-1]) . V[0..n-1] per head: q (B, SA), caches (B, T, SA) float32.

    As the kernel does it: over ``tile`` positions at a time; a prefix of one tile
    is normalised before its product with V, a longer one takes an online softmax
    (running maximum and sum, the accumulator rescaled from tile to tile)."""
    B, SA = q.shape
    qh = q.reshape(B, H, SA // H)

    def split(cache, lo, hi):
        return cache[:, lo:hi].reshape(B, hi - lo, H, SA // H)

    if n <= tile:
        probs = torch.softmax(torch.einsum("bhd,bthd->bht", qh, split(k_cache, 0, n)), dim=-1)
        return torch.einsum("bht,bthd->bhd", probs, split(v_cache, 0, n)).reshape(B, SA)
    m = torch.full((B, H), -torch.inf, dtype=q.dtype, device=q.device)
    total = torch.zeros(B, H, dtype=q.dtype, device=q.device)
    acc = torch.zeros(B, H, SA // H, dtype=q.dtype, device=q.device)
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        logits = torch.einsum("bhd,bthd->bht", qh, split(k_cache, lo, hi))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        total = total * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bht,bthd->bhd", p, split(v_cache, lo, hi))
        m = m_new
    return (acc / total[..., None]).reshape(B, SA)


def _decode_plain(p: PackedDecoder, ops: _Operands, max_iters: int, stop_threshold: float,
                  early_exit: bool, sa_tile: int = SA_TILE) -> DecodeResult:
    z = p.sizes
    B, S, _ = ops.mem1.shape
    T, R, M, A1 = max_iters, z["R"], z["M"], z["A1"]
    SA, H = z["SA"], z["H"]
    HD = SA // H if p.use_sa else 0
    device, io = p.flat.device, p.io_dtype
    f32 = dict(dtype=torch.float32, device=device)
    zeros = lambda *shape: torch.zeros(*shape, **f32)  # noqa: E731

    def rnd(x):
        # a product's input, rounded to the io type where the Pallas kernel casts it
        return x if io == torch.float32 else x.to(io).float()

    # io-type weights and conditioning as float32: exact, and summed in float32
    W = {name: p.mat(name).float() for name in _ENTRIES}
    keys_cat, mem1 = ops.keys_cat.float(), ops.mem1.float()
    mem2 = None if ops.mem2 is None else ops.mem2.float()
    spk = None if ops.spk is None else ops.spk.float()
    v_cat, inv_keep = p.vec("v_cat"), 1.0 / p.keep_prob
    even = (torch.arange(SA, device=device) % 2) == 0

    frames, stops = zeros(B, T, R * M), zeros(B, T, R)
    align1, align2 = zeros(B, T, S), zeros(B, T, S)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    lengths = torch.zeros(B, dtype=torch.int32, device=device)
    k_cache, v_cache = zeros(B, T, SA), zeros(B, T, SA)

    feed = zeros(B, M)
    c_att, h_att = zeros(B, z["AU"]), zeros(B, z["AU"])
    c1, h1, c2, h2 = (zeros(B, z["DU"]) for _ in range(4))
    if p.ls:
        # the additive family starts uniform; the taps read cum (or the alignments)
        alpha1 = torch.full((B, S), 1.0 / S, **f32)
        cum = zeros(B, S)
        w_ls, b_ls = W["ls_w"][: z["K"]], p.vec("ls_b")
    else:
        alpha1 = zeros(B, S)
        alpha1[:, 0] = 1.0
    u = torch.full((B, 1), 0.5, **f32)
    # one source: the second context has width 0 and so drops out of every input
    ctx1, ctx2 = zeros(B, z["E1"]), zeros(B, z["E2"])

    t = 0
    while t < T:
        x = torch.relu(feed @ W["p1_w"] + W["p1_b"])
        if ops.masks is not None:
            x = torch.where(ops.masks[0][t], x * inv_keep, torch.zeros_like(x))
        x = torch.relu(rnd(x) @ W["p2_w"] + W["p2_b"])
        if ops.masks is not None:
            x = torch.where(ops.masks[1][t], x * inv_keep, torch.zeros_like(x))

        parts = [x] + ([spk] if spk is not None else []) + [ctx1, ctx2, h_att]
        c_att, h_att = _lstm(rnd(torch.cat(parts, dim=-1)), W["attg_w"], W["attg_b"],
                             c_att, h_att, p)

        # the sources' scores from one tanh pass over the concatenated keys
        qp = rnd(h_att) @ W["qp_w"]
        pre = keys_cat + qp[:, None, :]
        if p.ls:
            # source 1's columns add the folded taps of the rounded alignments
            loc = location_taps(rnd(cum if p.ls_cumulative else alpha1), z["K"]) @ w_ls + b_ls
            pre = pre + torch.nn.functional.pad(loc, (0, z["A2"]))
        hidden = torch.tanh(pre) * v_cat
        e1 = hidden[..., :A1].sum(dim=-1) + ops.score_bias
        y1 = torch.softmax(e1, dim=-1)
        if p.ls:
            alpha1 = y1
            cum = cum + alpha1
        else:
            shifted = torch.nn.functional.pad(alpha1, (1, 0))[:, :-1]
            alpha_hat = ((1.0 - u) * alpha1 + u * shifted + _EPS) * y1
            alpha1 = alpha_hat / alpha_hat.sum(dim=-1, keepdim=True)
        ctx1 = (alpha1[:, :, None] * mem1).sum(dim=1)
        if p.use_transition_agent:
            ta_in = rnd(torch.cat([ctx1, h_att], dim=-1))
            u = torch.sigmoid(ta_in @ p.vec("ta_w").float() + p.vec("ta_b").float())[:, None]
        if p.dual:
            e2 = hidden[..., A1:].sum(dim=-1) + ops.score_bias
            alpha2 = torch.softmax(e2, dim=-1)
            ctx2 = (alpha2[:, :, None] * mem2).sum(dim=1)
            align2[:, t] = alpha2

        din = rnd(torch.cat([h_att, ctx1, ctx2, h1], dim=-1))
        c1, h1 = _lstm(din, W["l1_w"], W["l1_b"], c1, h1, p)
        c2, h2 = _lstm(rnd(torch.cat([h1, h2], dim=-1)), W["l2_w"], W["l2_b"], c2, h2, p)
        y = feature = h2 + h1

        if p.use_sa:
            # causal self-attention block over the live prefix 0..t of the cache
            angle = t * p.pe_rate
            pe = torch.where(even, torch.sin(angle), torch.cos(angle)).to(torch.float32)
            xs = rnd(feature) @ W["in_w"] + W["in_b"] + pe
            qkv = rnd(_layer_norm(xs, W["ln1_s"], W["ln1_b"], p.ln_eps)) @ W["qkv_w"]
            q = qkv[:, :SA] / math.sqrt(HD)
            k_cache[:, t], v_cache[:, t] = rnd(qkv[:, SA : 2 * SA]), rnd(qkv[:, 2 * SA :])
            attn = _attend(q, k_cache, v_cache, t + 1, H, sa_tile)
            xs = xs + rnd(attn) @ W["o_w"] + W["o_b"]
            ffn = torch.relu(
                rnd(_layer_norm(xs, W["ln2_s"], W["ln2_b"], p.ln_eps)) @ W["f1_w"] + W["f1_b"]
            )
            y = xs + rnd(ffn) @ W["f2_w"] + W["f2_b"]

        out = rnd(y) @ W["out_w"] + W["out_b"]
        frames[:, t] = out[:, : R * M]
        stop_probs = torch.sigmoid(out[:, R * M :])
        stops[:, t] = stop_probs
        align1[:, t] = alpha1

        fired_mask = stop_probs > stop_threshold
        fired = fired_mask.any(dim=-1)
        first_fire = fired_mask.int().argmax(dim=-1)
        newly = fired & ~finished
        lengths = torch.where(newly, (t * R + first_fire + 1).to(torch.int32), lengths)
        finished = finished | fired
        feed = out[:, (R - 1) * M : R * M]
        if z["LF0"]:
            # the lf0 class logits feed back as probabilities, rounded once after the softmax
            lf0 = z["LF0"]
            feed = torch.cat([feed[:, :lf0], torch.softmax(feed[:, lf0:], dim=-1)], dim=-1)
        feed = rnd(feed)

        t += 1
        if early_exit and bool(finished.all()):
            break

    lengths = torch.where(finished, lengths, torch.full_like(lengths, t * R))
    return DecodeResult(
        frames=_split_frames(p, frames.reshape(B, T * R, M)),
        stop_probs=stops.reshape(B, T * R),
        lengths=lengths,
        alignments=(align1, align2) if p.dual else (align1,),
        finished=finished,
        num_steps=torch.tensor(t, dtype=torch.int32, device=device),
    )


def _split_frames(p: PackedDecoder, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    # (B, T * R, M) frame rows -> {head: (B, T * R, width)}, in the decoder's head order
    heads, offset = {}, 0
    for head, dim in p.heads:
        heads[head] = frames[..., offset : offset + dim]
        offset += dim
    return heads


def fused_decode_reference(
    packed: PackedDecoder,
    cond: DecoderConditioning,
    prenet_masks: Optional[Sequence[torch.Tensor]],
    max_iters: int,
    stop_threshold: float,
    early_exit: bool = True,
    sa_tile: int = SA_TILE,
) -> DecodeResult:
    """Plain PyTorch version of one launch of ``fused_decode``, in the kernel's formulation.

    Concatenated keys against ``[v1 | v2]`` (``v1`` alone with one source), the
    location features where source 1 is location-sensitive (taps of the rounded
    alignments times the folded matrix, plus its float32 bias), the key mask as an
    added -1e9, the query scaled by ``1 / sqrt(HD)`` before the
    dot, attention over the live prefix of the cache in tiles of ``sa_tile``
    positions (the kernel's is ``SA_TILE``; a test may take a smaller one to
    reach the online softmax in a few steps), dropout as ``x * (1 / keep)`` where
    the mask keeps; the specialisation's stages only; the fed-back frame's lf0
    lanes softmaxed in float32 (the WORLD heads); in bfloat16 the inputs of
    the products rounded where the kernel rounds them, everything else float32.
    All lanes run until every lane has fired (``early_exit``) or to ``max_iters``.
    """
    ops = _operands(packed, cond, prenet_masks, int(max_iters))
    with torch.no_grad():
        return _decode_plain(packed, ops, int(max_iters), float(stop_threshold), bool(early_exit),
                             int(sa_tile))


# --------------------------------------------------------------------------- #
# The kernel
# --------------------------------------------------------------------------- #


def _kernel_fn():
    global _function
    if _function is None:
        fn = load_library("fused_decode").fused_decode_launch
        # the 19 device pointers (an array), the sizes (host), the scalars (host), the stream
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _function = fn
    return _function


def _dims(sizes: Dict[str, int], B: int, S: int, T: int, flags=(0, 0, 0, 0),
          io_dtype=torch.float32, offsets=None, stamp_step: int = -1):
    # the struct ``Dims`` of the source: sizes, (transition agent, early exit, masks,
    # cumulative location taps, bfloat16, the stamped step), offsets
    values = [B, S, T] + [sizes[k] for k in _SIZES] + [int(f) for f in flags]
    values += [int(io_dtype == torch.bfloat16), int(stamp_step)]
    values += [0] * len(_ENTRIES) if offsets is None else [offsets[name] for name in _ENTRIES]
    return (ctypes.c_int * len(values))(*values)


def _library():
    lib = load_library("fused_decode")
    lib.fused_decode_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.fused_decode_smem_bytes.restype = ctypes.c_longlong
    lib.fused_decode_smem_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_decode_smem_limit.restype = ctypes.c_longlong
    lib.fused_decode_scratch_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.fused_decode_scratch_bytes.restype = ctypes.c_longlong
    return lib


def block_shared_memory(sizes: Dict[str, int], device,
                        io_dtype=torch.float32) -> Tuple[int, int]:
    """(bytes of shared memory one block needs at the least on ``device``'s grid, one
    block per SM; bytes a block may have there), both as the built kernel reports
    them. The first grows neither with the source length nor with ``max_iters``."""
    lib = _library()
    dims = _dims(sizes, 1, 1, 1, io_dtype=io_dtype)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        limit = int(lib.fused_decode_smem_limit(dims))
    if limit < 0:
        raise RuntimeError(f"fused_decode: CUDA error {-limit} on reading the device's limits")
    return int(lib.fused_decode_smem_bytes(dims, sms)), limit


def _launch_limit(sizes: Dict[str, int], device, io_dtype=torch.float32) -> int:
    need, have = block_shared_memory(sizes, device, io_dtype)
    return MAX_LANES if need <= have else 0


def _decode_kernel(p: PackedDecoder, ops: _Operands, max_iters: int, stop_threshold: float,
                   early_exit: bool, stamps: Optional[Tuple[int, torch.Tensor]] = None
                   ) -> DecodeResult:
    global launch_count
    z = p.sizes
    B, S, _ = ops.mem1.shape
    T, R, M, SA = max_iters, z["R"], z["M"], z["SA"]
    device, io = p.flat.device, p.io_dtype
    f32 = dict(dtype=torch.float32, device=device)
    # rows at and beyond num_steps stay zero, as the step-by-step path leaves them
    frames, stops = torch.zeros(B, T, R * M, **f32), torch.zeros(B, T, R, **f32)
    aligns = tuple(torch.zeros(B, T, S, **f32) for _ in range(2 if p.dual else 1))
    lengths = torch.zeros(B, dtype=torch.int32, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    # [0] num_steps, [1] the grid barrier's arrival counter
    info = torch.zeros(2, dtype=torch.int32, device=device)
    # what a specialisation does not have is a placeholder that the kernel never reads
    placeholder = torch.zeros(4, **f32)
    if p.use_sa:
        # scratch in the io type: K transposed (B, SA, T4), V (B, T, SA); only the
        # written prefix is read
        k_cache = torch.empty(B, SA, _round4(T), dtype=io, device=device)
        v_cache = torch.empty(B, T, SA, dtype=io, device=device)
        pe_rate = p.pe_rate
    else:
        k_cache = v_cache = pe_rate = placeholder

    stamp_step, stamp_buffer = stamps if stamps is not None else (-1, None)
    dims = _dims(z, B, S, T, (p.use_transition_agent, early_exit, ops.masks is not None,
                              p.ls_cumulative), io, p.offsets, stamp_step)
    # the per-lane rows of the stages, zeroed: the decoder's initial state
    scratch = torch.zeros(int(_library().fused_decode_scratch_bytes(dims)) // 4 + 4, **f32)
    scalars = (ctypes.c_float * 7)(
        p.zoneout_cell, p.zoneout_output, p.forget_bias, 1.0 / p.keep_prob,
        stop_threshold, p.ln_eps, math.sqrt(SA // z["H"]) if p.use_sa else 1.0,
    )
    tensors = [
        p.flat, p.flat32, pe_rate, ops.keys_cat, ops.mem1,
        placeholder if ops.mem2 is None else ops.mem2, ops.score_bias, ops.spk,
        *(ops.masks if ops.masks is not None else (None, None)),
        k_cache, v_cache, frames, stops, aligns[0], aligns[-1] if p.dual else placeholder,
        lengths, finished, info, scratch, stamp_buffer,
    ]
    pointers = (ctypes.c_void_p * len(tensors))(
        *(None if x is None else x.data_ptr() for x in tensors)
    )
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(pointers, dims, scalars, stream)
    if err != 0:
        raise RuntimeError(f"fused_decode kernel launch failed: CUDA error {err}")
    launch_count += 1
    name = variant_name(p.dual, p.use_sa, io, p.ls, p.lf0)
    variant_launches[name] = variant_launches.get(name, 0) + 1
    return DecodeResult(
        frames=_split_frames(p, frames.view(B, T * R, M)),
        stop_probs=stops.view(B, T * R),
        lengths=lengths,
        alignments=aligns,
        finished=finished,
        num_steps=info[0],
    )


def stage_times(packed: PackedDecoder, cond: DecoderConditioning,
                prenet_masks: Optional[Sequence[torch.Tensor]], max_iters: int,
                stamp_step: int) -> Dict[str, float]:
    """Microseconds of each stage of decoder step ``stamp_step`` in one launch on the
    card, to the cap (no early exit), from the ``%globaltimer`` stamps block 0 writes
    at the step's start and, for each stage, when its input rows are in shared memory
    (product stages), at its arrival at the stage's grid barrier and at its
    departure: ``{stage: µs from the previous departure to this one}``,
    ``{stage + "_copy": µs from the previous departure until the rows are in}``,
    ``{stage + "_wait": µs from block 0's arrival to its departure}``; ``step``: the
    whole step. The stamps are compiled into the flagship's structure alone (every
    other instantiation, and the flagship's own when it is not stamped, has no stamp
    code). One launch, counted as any other."""
    device = packed.flat.device
    if device.type != "cuda":
        raise RuntimeError("stage_times needs the weights on a CUDA device")
    _require(0 <= stamp_step < max_iters, "the stamped step must be one that runs")
    _require(packed.dual and packed.use_sa and not packed.ls and not packed.lf0,
             "the stamps are compiled for the flagship's structure alone (two sources, "
             "self-attention, forward attention, the mel head)")
    B, S = cond.memories[0].shape[:2]
    _require(B <= MAX_LANES, f"one launch takes at most {MAX_LANES} lanes")
    buffer = torch.zeros(_STAMP_SLOTS, dtype=torch.int64, device=device)
    ops = _operands(packed, cond, prenet_masks, int(max_iters))
    with torch.no_grad():
        _decode_kernel(packed, ops, int(max_iters), 2.0, False, stamps=(int(stamp_step), buffer))
    stamps = buffer.cpu().tolist()
    times, last = {}, stamps[0]
    for i, stage in enumerate(stages(packed.use_sa)):
        copied, arrive, leave = stamps[1 + 3 * i : 4 + 3 * i]
        times[stage] = (leave - last) / 1e3
        if copied:
            times[stage + "_copy"] = (copied - last) / 1e3
        times[stage + "_wait"] = (leave - arrive) / 1e3
        last = leave
    times["step"] = (last - stamps[0]) / 1e3
    return times


# --------------------------------------------------------------------------- #
# The wrapper
# --------------------------------------------------------------------------- #


def _slice_cond(cond: DecoderConditioning, start: int, end: int) -> DecoderConditioning:
    cut = lambda x: None if x is None else x[start:end]  # noqa: E731
    return DecoderConditioning(
        memories=tuple(cut(m) for m in cond.memories),
        keys=tuple(cut(k) for k in cond.keys),
        masks=tuple(cut(m) for m in cond.masks),
        speaker_embed=cut(cond.speaker_embed),
    )


def fused_decode(
    packed: PackedDecoder,
    cond: DecoderConditioning,
    prenet_masks: Optional[Sequence[torch.Tensor]],
    max_iters: int,
    stop_threshold: float,
    early_exit: bool = True,
    slice_batch: Optional[int] = None,
) -> DecodeResult:
    """Decode a whole request; returns the ``DecodeResult`` of ``ops/decode_loop.py``.

    Weights and conditioning on a CUDA device go to the kernel or raise; on the
    CPU they go to ``fused_decode_reference``. ``prenet_masks``: one
    (max_iters, B, units) boolean keep-mask per prenet layer, or None when the
    prenet's drop rate is 0.

    Inside one launch all lanes run until every lane has fired or to
    ``max_iters``. A batch above the launch limit (see
    ``fused_decode_max_batch``; ``slice_batch`` overrides it) runs as sequential
    batch blocks: per-lane frames up to the lane's length, lengths and flags are
    those of one launch, ``num_steps`` is the maximum over the blocks, and a
    block's rows between its own exit and ``num_steps`` are zero.
    """
    device = packed.flat.device
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_decode has no kernel for device {device}")
    max_iters = int(max_iters)
    B, S = cond.memories[0].shape[:2]
    limit = B   # the plain version takes any batch
    if device.type == "cuda":
        limit = _launch_limit(packed.sizes, device, packed.io_dtype)
        if limit < 1:
            need, have = block_shared_memory(packed.sizes, device, packed.io_dtype)
            raise RuntimeError(
                f"fused_decode cannot launch: one block needs {need} bytes of shared memory, "
                f"an SM of this device offers {have}"
            )
    if slice_batch is not None:
        limit = int(slice_batch)
        if limit < 1:
            raise ValueError("fused_decode: slice_batch must be at least 1")
    if B > limit:
        parts = [
            fused_decode(
                packed, _slice_cond(cond, start, min(start + limit, B)),
                None if prenet_masks is None else [
                    torch.as_tensor(m)[:, start : start + limit] for m in prenet_masks
                ],
                max_iters, stop_threshold, early_exit, slice_batch=limit,
            )
            for start in range(0, B, limit)
        ]
        return DecodeResult(
            frames={h: torch.cat([r.frames[h] for r in parts]) for h in parts[0].frames},
            stop_probs=torch.cat([r.stop_probs for r in parts]),
            lengths=torch.cat([r.lengths for r in parts]),
            alignments=tuple(
                torch.cat([r.alignments[i] for r in parts]) for i in range(len(parts[0].alignments))
            ),
            finished=torch.cat([r.finished for r in parts]),
            num_steps=torch.stack([r.num_steps for r in parts]).max(),
        )
    ops = _operands(packed, cond, prenet_masks, max_iters)
    run = _decode_plain if device.type == "cpu" else _decode_kernel
    with torch.no_grad():
        return run(packed, ops, max_iters, float(stop_threshold), bool(early_exit))
