"""The teacher-forced decoder's recurrent region (``fused_teacher_fwd`` and
``_bwd``) over a training batch, each lane over its own valid steps.

Forward operations: the scan's products and the attention over the lane's
positions at every step (``model_step.scan_products``,
``attention_per_position``); the backward twice the forward's. Bytes of the
forward: the scan's weights, each lane's prenet rows, keys and memories in the
compute dtype; its features, alignments and the per-step states the backward
reads (the LSTMs' cells and outputs, the contexts, both alignments) in
float32. The backward reads what the forward wrote and the features'
gradients, and writes every weight's gradient in float32 and the rows'
gradients in the compute dtype."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from port_bench.counts import model_step
from port_bench.counts.peaks import IO_BYTES


def forward_flops(hp: Dict, S: int, N: int) -> float:
    return N * (2.0 * model_step.scan_products(hp) + S * model_step.attention_per_position(hp))


def _lane_bytes(hp: Dict, S: int, N: int) -> Tuple[float, float]:
    io = IO_BYTES[hp["compute_dtype"]]
    A, D = hp["attention_out_units"], hp["decoder_out_units"]
    a = hp["attention1_out_units"] + hp["attention2_out_units"]
    e = hp["cbhg_out_units"] + hp["self_attention_out_units"]
    pre = hp["decoder_prenet_out_units"][-1]
    rows_in = io * (N * pre + S * (a + e)) + 4 * S
    states = 4.0 * N * (2 * A + 4 * D + e + 2 * S)
    features = 4.0 * N * D
    fwd = rows_in + states + features
    bwd = states + features + rows_in + features
    return fwd, bwd


def flops_and_bytes(hp: Dict, lanes: Iterable[Tuple[int, int]]) -> Tuple[float, float]:
    """Forward and backward together; ``lanes``: (S, N) per lane."""
    io = IO_BYTES[hp["compute_dtype"]]
    weights = model_step.scan_products(hp)
    flops, nbytes = 0.0, float(io * weights + io * weights + 4 * weights)
    for S, N in lanes:
        flops += 3.0 * forward_flops(hp, S, N)
        fwd, bwd = _lane_bytes(hp, S, N)
        nbytes += fwd + bwd
    return flops, nbytes
