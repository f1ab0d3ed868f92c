"""The whole-loop decode (``fused_decode``): a request's decoder steps, each lane
up to its own stop.

Operations: ``model_step.decode`` of each lane. Bytes: the step's weights once
(matrices in the compute dtype, vectors in float32), each lane's keys and
memories in the compute dtype and its key mask, its prenet masks (a byte a
unit), and its outputs in float32: r frames and r stop probabilities a step and
both sources' alignments over its positions, its length and flag."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from port_bench.counts import model_step
from port_bench.counts.peaks import IO_BYTES


def vectors(hp: Dict) -> int:
    """Biases, norms' scales and the score vectors of a step."""
    A, D = hp["attention_out_units"], hp["decoder_out_units"]
    U, r, M = hp["decoder_self_attention_out_units"], hp["outputs_per_step"], hp["num_mels"]
    p = hp["decoder_prenet_out_units"]
    return (p[0] + p[1] + 4 * A + 8 * D + hp["attention1_out_units"]
            + hp["attention2_out_units"] + U + 3 * U + 4 * U + 1024 + U + r * M + r)


def flops_and_bytes(hp: Dict, lanes: Iterable[Tuple[int, int]]) -> Tuple[float, float]:
    """``lanes``: (S, N) per lane."""
    io = IO_BYTES[hp["compute_dtype"]]
    a = hp["attention1_out_units"] + hp["attention2_out_units"]
    e = hp["cbhg_out_units"] + hp["self_attention_out_units"]
    r, M = hp["outputs_per_step"], hp["num_mels"]
    units = sum(hp["decoder_prenet_out_units"])
    flops = 0.0
    nbytes = float(io * model_step.step_products(hp) + 4 * vectors(hp))
    for S, N in lanes:
        flops += model_step.decode(hp, S, N)
        nbytes += S * (io * (a + e) + 4) + N * units + 4.0 * N * (r * M + r + 2 * S) + 9
    return flops, nbytes
