"""Operations of the whole model: a synthesis request and a training step.

Every lane is counted at its own lengths: ``S`` source symbols, ``N`` decoder
steps (its frames / r, up to its own stop or the cap), ``T = N * r`` frames.
The decoder's self-attention over its own past is counted causally, ``t + 1``
positions at step ``t``; the encoder's over all ``S``. A training step is its
teacher-forced forward and a backward of twice its operations.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple


def dense(rows: int, k: int, n: int) -> float:
    return 2.0 * rows * k * n


def _cbhg(S: int, in_units: int, out_units: int, channels: int, width: int, p1: int, p2: int,
          highways: int) -> float:
    half = out_units // 2
    ops = dense(S, in_units * width * (width + 1) // 2, channels)   # the bank, taps 1..width
    ops += dense(S, 3 * channels * width, p1) + dense(S, 3 * p1, p2)
    if p2 != half:
        ops += dense(S, p2, half)
    ops += highways * 2 * dense(S, half, half)
    ops += 2 * (dense(S, 2 * half, 2 * half) + dense(S, 2 * half, half))  # BiGRU, two directions
    return ops


def _self_attention(S: int, in_units: int, units: int, ffn: int, hops: int,
                    causal: bool) -> float:
    ops = dense(S, in_units, units)
    positions = S * (S + 1) / 2 if causal else S * S
    for _ in range(hops):
        ops += dense(S, units, 3 * units) + 4.0 * positions * units
        ops += dense(S, units, units) + dense(S, units, ffn) + dense(S, ffn, units)
    return ops


def encoder(hp: Dict, S: int) -> float:
    """Embedding to keys: prenet, CBHG, self-attention, both memory layers."""
    p = hp["encoder_prenet_out_units"]
    ops = dense(S, hp["embedding_dim"], p[0]) + dense(S, p[0], p[1])
    ops += _cbhg(S, p[1], hp["cbhg_out_units"], hp["conv_channels"], hp["max_filter_width"],
                 hp["projection1_out_channels"], hp["projection2_out_channels"], hp["num_highway"])
    ops += _self_attention(S, hp["cbhg_out_units"], hp["self_attention_out_units"],
                           hp["self_attention_transformer_ffn_units"],
                           hp["self_attention_num_hop"], causal=False)
    ops += dense(S, hp["cbhg_out_units"], hp["attention1_out_units"])
    ops += dense(S, hp["self_attention_out_units"], hp["attention2_out_units"])
    return ops


def scan_products(hp: Dict) -> int:
    """Weights of the recurrent region of a decoder step (the teacher kernels'
    scan): the attention LSTM, the fused query projection, the decoder LSTMs
    and the forward attention's transition agent where used."""
    A, D = hp["attention_out_units"], hp["decoder_out_units"]
    E = hp["cbhg_out_units"] + hp["self_attention_out_units"]
    pre = hp["decoder_prenet_out_units"][-1]
    out = (pre + E + A) * 4 * A + A * (hp["attention1_out_units"] + hp["attention2_out_units"])
    out += (A + E + D) * 4 * D + 2 * D * 4 * D
    if hp["use_forward_attention_transition_agent"]:
        out += hp["cbhg_out_units"] + A
    return out


def step_products(hp: Dict) -> int:
    """Weights of a whole synthesis step: the prenet, the scan, the decoder's
    self-attention (1024 wide feed-forward) and the output product."""
    M, r = hp["num_mels"] * hp["n_feed_frame"], hp["outputs_per_step"]
    p = hp["decoder_prenet_out_units"]
    D, U = hp["decoder_out_units"], hp["decoder_self_attention_out_units"]
    sa = hp["decoder_self_attention_num_hop"] * (U * 3 * U + U * U + 2 * U * 1024)
    return M * p[0] + p[0] * p[1] + scan_products(hp) + D * U + sa + U * (r * hp["num_mels"] + r)


def attention_per_position(hp: Dict) -> float:
    """Operations per step and source position: both scores (add, tanh, the
    product with the score vector) and both contexts."""
    a = hp["attention1_out_units"] + hp["attention2_out_units"]
    e = hp["cbhg_out_units"] + hp["self_attention_out_units"]
    return 4.0 * a + 2.0 * e


def decode(hp: Dict, S: int, N: int) -> float:
    """A lane's ``N`` synthesis steps over ``S`` positions."""
    U = hp["decoder_self_attention_out_units"] * hp["decoder_self_attention_num_hop"]
    return N * (2.0 * step_products(hp) + S * attention_per_position(hp)) + 4.0 * U * N * (N + 1) / 2


def postnets(hp: Dict, T: int) -> float:
    ops = 0.0
    M = hp["num_mels"]
    if hp["use_postnet_v2"]:
        k, c, layers = hp["postnet_v2_kernel_size"], hp["postnet_v2_out_channels"], hp["postnet_v2_num_layers"]
        ops += dense(T, k * M, c) + (layers - 2) * dense(T, k * c, c) + dense(T, k * c, M)
    if hp["use_linear_spectrogram_postnet"]:
        ops += _cbhg(T, M, 256, 128, 8, 256, M, 4) + dense(T, 256, hp["num_freq"])
    return ops


def synthesis(hp: Dict, lanes: Iterable[Tuple[int, int]]) -> float:
    """A request's operations; ``lanes`` are (S, N) per lane."""
    r = hp["outputs_per_step"]
    return sum(encoder(hp, S) + decode(hp, S, N) + postnets(hp, N * r) for S, N in lanes)


def training(hp: Dict, lanes: Iterable[Tuple[int, int]]) -> float:
    """A step's operations: three times the teacher-forced forward, which is the
    encoder and the decoder steps as synthesis counts them, over each lane's
    valid target steps."""
    return 3.0 * synthesis(hp, lanes)
