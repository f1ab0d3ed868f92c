"""The frozen work counters against hand counts at tiny widths, and the decode
counter against ``chip_smoke.py::fused_flops_and_bytes`` where every lane runs
the same steps."""

import ast
import os

import numpy as np
import pytest

import tiny
from conftest import ROOT
from port_bench.counts import fused_decode, fused_teacher, model_step
from port_bench.counts.peaks import least_seconds

HP = tiny.config("flagship", compute_dtype="float32")["hparams"]

# Hand counts of the tiny flagship (M=8, r=2, prenet 16/8, A=16, E=16+16, a=12+4,
# D=16, the decoder's self-attention 16 wide with its feed-forward of 1024):
# prenet 8*16 + 16*8; attention LSTM (8 + 32 + 16) * 64; query projection 16*16;
# LSTMs (16 + 32 + 16) * 64 and 32 * 64; self-attention 16*16 + 16*48 + 16*16 +
# 2*16*1024; output 16 * (2*8 + 2).
STEP_PRODUCTS = 256 + 3584 + 256 + 4096 + 2048 + 34048 + 288
SCAN_PRODUCTS = 3584 + 256 + 4096 + 2048
PER_POSITION = 4 * 16 + 2 * 32


def test_decode_counts_by_hand():
    assert model_step.step_products(HP) == STEP_PRODUCTS
    assert model_step.attention_per_position(HP) == PER_POSITION
    # 3 steps over 5 positions, the self-attention over 1, 2, 3 positions
    want = 3 * (2 * STEP_PRODUCTS + 5 * PER_POSITION) + 4 * 16 * (1 + 2 + 3)
    assert model_step.decode(HP, 5, 3) == want
    flops, _ = fused_decode.flops_and_bytes(HP, [(5, 3), (7, 1)])
    assert flops == want + model_step.decode(HP, 7, 1)


def test_encoder_counts_by_hand():
    S = 6
    prenet = 2 * S * (16 * 16 + 16 * 8)
    bank = 2 * S * 8 * 8 * (1 + 2 + 3 + 4)
    projections = 2 * S * (3 * 32 * 8) + 2 * S * (3 * 8 * 8)
    highways = 4 * 2 * 2 * S * 8 * 8
    gru = 2 * 2 * S * (16 * 16 + 16 * 8)
    attention = (2 * S * 16 * 16 + 2 * S * 16 * 48 + 4 * S * S * 16 + 2 * S * 16 * 16
                 + 2 * 2 * S * 16 * 32)
    keys = 2 * S * 16 * 12 + 2 * S * 16 * 4
    assert model_step.encoder(HP, S) == prenet + bank + projections + highways + gru + attention + keys


def test_teacher_and_training_counts_by_hand():
    fwd = 4 * (2 * SCAN_PRODUCTS + 5 * PER_POSITION)
    flops, nbytes = fused_teacher.flops_and_bytes(HP, [(5, 4)])
    assert flops == 3 * fwd and nbytes > 0
    lanes = [(5, 4), (6, 2)]
    assert model_step.training(HP, lanes) == 3 * model_step.synthesis(HP, lanes)


def test_postnet_counts_by_hand():
    hp = tiny.config("streaming", compute_dtype="float32")["hparams"]
    T = 9
    v2 = 2 * T * 5 * 8 * 16 + 3 * 2 * T * 5 * 16 * 16 + 2 * T * 5 * 16 * 8
    cbhg = (2 * T * 8 * 36 * 128 + 2 * T * 3 * 128 * 8 * 256 + 2 * T * 3 * 256 * 8
            + 2 * T * 8 * 128 + 4 * 2 * 2 * T * 128 * 128
            + 2 * (2 * T * 256 * 256 + 2 * T * 256 * 128))
    assert model_step.postnets(hp, T) == v2 + cbhg + 2 * T * 256 * 9


def test_least_time_takes_the_larger_bound():
    assert least_seconds(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert least_seconds(0.0, 3.35e12, "float32") == pytest.approx(1.0)


def _chip_smoke_counter():
    """``chip_smoke.py::fused_flops_and_bytes`` alone (the script exits at import
    without a card)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    fn = [n for n in tree.body
          if isinstance(n, ast.FunctionDef) and n.name == "fused_flops_and_bytes"][0]
    namespace = {"np": np}
    exec(compile(ast.Module([fn], []), "chip_smoke.py", "exec"), namespace)
    return namespace["fused_flops_and_bytes"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_counter_agrees_with_chip_smoke_on_operations(dtype):
    from self_attention_tacotron_torch.hparams import HParams
    from self_attention_tacotron_torch.models.models import tacotron_model_factory
    from self_attention_tacotron_torch.ops.fused_decode import pack_decoder

    hp = tiny.config("flagship", compute_dtype=dtype)["hparams"]
    net = tacotron_model_factory(HParams().override_from_dict(hp)).network(device="cpu")
    lengths, steps = np.array([5, 7, 9]), 4
    theirs_flops, theirs_bytes, _ = _chip_smoke_counter()(pack_decoder(net.decoder), lengths, steps)
    flops, nbytes = fused_decode.flops_and_bytes(hp, [(int(s), steps) for s in lengths])
    assert flops == theirs_flops
    # bytes differ by convention: chip_smoke reads the packed buffers whole (with
    # the transition agent's zero row and a score vector per source in float32)
    # and every lane's rows at the batch's longest source; here each lane's at its own
    print(f"{dtype}: bytes {nbytes:.0f} here, {theirs_bytes:.0f} in chip_smoke.py")
    assert abs(nbytes - theirs_bytes) / theirs_bytes < 0.05
