"""``convert``: the committed trained npz fills the full-width flagship model."""

import os

import numpy as np
import pytest
import torch

from self_attention_tacotron_torch import convert
from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import TacotronNetwork

NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts", "convergence_long_r5", "trained_params.npz",
)


def _flagship():
    return HParams(
        tacotron_model="DualSourceSelfAttentionTacotronModel",
        encoder="SelfAttentionCBHGEncoder",
        decoder="DualSourceSelfAttentionDecoder",
        attention="forward",
        attention2="additive",
        num_symbols=256,
    )


@pytest.fixture(scope="module")
def flat():
    with np.load(NPZ) as archive:
        return {k: archive[k] for k in archive.files}


def test_every_key_is_placed_and_every_entry_filled(flat):
    assert len(flat) == 162
    hp = _flagship()
    net = TacotronNetwork(hp)
    state = convert.flax_to_torch_state(flat, hp, net)
    expected = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(state) == expected
    assert len(state) == 162
    for key, value in net.state_dict().items():
        if key in state:
            assert state[key].shape == value.shape and state[key].dtype == value.dtype


def test_layouts(flat):
    state = convert.flax_to_torch_state(flat, _flagship())
    # Dense (in, out) -> Linear (out, in)
    k = flat["params/decoder/attention_lstm/gates/kernel"]
    np.testing.assert_array_equal(state["decoder.attention_lstm.gates.weight"].numpy(), k.T)
    assert state["decoder.attention_lstm.gates.weight"].shape == (1024, 896)
    # Conv (K, in, out) -> Conv1d (out, in, K)
    k = flat["params/encoder/cbhg/conv_bank_5/Conv_0/kernel"]
    w = state["encoder.cbhg.conv_bank_5.Conv_0.weight"].numpy()
    assert w.shape == (128, 128, 5)
    np.testing.assert_array_equal(w[3, 7, 2], k[2, 7, 3])
    # BatchNorm: scale/bias and the running statistics
    np.testing.assert_array_equal(
        state["encoder.cbhg.proj1.BatchNorm_0.running_var"].numpy(),
        flat["batch_stats/encoder/cbhg/proj1/BatchNorm_0/var"],
    )
    np.testing.assert_array_equal(
        state["encoder.cbhg.proj1.BatchNorm_0.weight"].numpy(),
        flat["params/encoder/cbhg/proj1/BatchNorm_0/scale"],
    )
    # GRU kernels keep (C + H, .), rows [x | h]
    np.testing.assert_array_equal(
        state["encoder.cbhg.birnn.cell_fwd.gates.kernel"].numpy(),
        flat["params/encoder/cbhg/gru_fwd/gates/kernel"],
    )
    # the mechanisms sit at the top of the flax tree and inside the port's decoder
    np.testing.assert_array_equal(
        state["decoder.attention_0.attention_v"].numpy(), flat["params/attention_0/attention_v"]
    )
    assert state["decoder.query_projection.weight"].shape == (256, 256)
    assert state["embedding.embedding"].shape == (256, 256)


def test_unplaced_key_and_unfilled_entry_raise(flat):
    hp = _flagship()
    extra = dict(flat)
    extra["params/decoder/nowhere/kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="nowhere"):
        convert.flax_to_torch_state(extra, hp)
    odd_leaf = dict(flat)
    odd_leaf["params/decoder/prenet/Dense_0/scale"] = np.zeros((256,), np.float32)
    with pytest.raises(KeyError, match="scale"):
        convert.flax_to_torch_state(odd_leaf, hp)
    fewer = {k: v for k, v in flat.items() if "highway_2/T/bias" not in k}
    with pytest.raises(KeyError, match="highway_2.T.bias"):
        convert.flax_to_torch_state(fewer, hp)
    wrong = dict(flat)
    wrong["params/embedding/embedding"] = np.zeros((70, 256), np.float32)
    with pytest.raises(ValueError, match="embedding"):
        convert.flax_to_torch_state(wrong, hp)


def test_load_npz_on_the_cpu_gives_an_eval_network_and_needs_a_card_by_default():
    hp = _flagship()
    net = convert.load_npz(NPZ, hp, device="cpu")
    assert not net.training
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in net.parameters())
    with np.load(NPZ) as archive:
        np.testing.assert_array_equal(
            net.decoder.output_projection.bias.detach().numpy(),
            archive["params/decoder/output_projection/bias"],
        )
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.load_npz(NPZ, hp)
