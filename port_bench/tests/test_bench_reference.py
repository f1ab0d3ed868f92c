"""The plain reference against the program's plain path at narrow widths on the
same weights, inputs and dropout masks: each configuration's synthesis (the
program's step loop on the CPU, the reference teacher-forced on its frames) and
three training steps, in float32, where the two must agree to rounding."""

import numpy as np
import pytest
import torch

import tiny
from port_bench import check, harness
from port_bench.reference import tacotron
from port_bench.reference import weights as ref_weights


def run(cell_name, dtype="float32", seconds=0.3, traced=False, **kwargs):
    bench = tiny.bench()
    spec = {w["name"]: w for w in bench["workloads"]}[cell_name]
    cell = harness.Cell(bench, cell_name, config=tiny.config(spec["config"], compute_dtype=dtype),
                        traffic=tiny.traffic(spec["traffic"]))
    return harness.run_cell(cell, 2**31 + 99, seconds, traced, device="cpu", **kwargs)


@pytest.mark.parametrize("cell_name", ["flagship.synth-batch32", "streaming.synth-batch64",
                                       "flagship.request-b1", "flagship-init.train-batch32"])
def test_reference_agrees_with_the_programs_plain_path(cell_name):
    result = run(cell_name, control=True)
    readings = result["readings"]
    assert result["attempted"] > 0
    for name, value in readings.items():
        limit = 0 if name == "length_mismatch" else 2e-5
        assert value <= limit, (name, value)
    if "postnet_gap" in readings:
        assert set(readings) >= {"postnet_gap", "linear_gap"}


@pytest.mark.parametrize("cell_name", ["flagship.request-b1", "flagship-init.train-batch32"])
def test_a_traced_run_drives_each_stretch_and_stays_correct(cell_name):
    result = run(cell_name, seconds=0.4, traced=True)
    assert result["correct"], result["checks"]
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["breakdown"]["idle_gaps"]
    # no device on the CPU: the shares of the trace find nothing to read
    assert not any(name.startswith(("device_idle_pct", "fused_")) for name in result["metrics"])
    assert any(name.startswith("mfu.") for name in result["metrics"])


def test_bfloat16_program_reads_above_float32_rounding():
    readings = run("flagship.synth-batch32", dtype="bfloat16", control=True)["readings"]
    assert 1e-4 < readings["mel_gap"] < 0.5


def test_fp8_control_moves_the_reference():
    hp = tiny.config("flagship", compute_dtype="bfloat16")["hparams"]
    flat = ref_weights.draw_flat(hp, 3, "cpu")
    net = tacotron.network(hp, flat, "cpu").eval()
    source = torch.tensor([[30, 31, 65, 32, 1]])
    lengths = torch.tensor([5])
    mel = torch.rand(1, 8, hp["num_mels"], generator=torch.Generator().manual_seed(0))
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    with torch.no_grad():
        want = net(source, lengths, mel, torch.tensor([8]), generator=gen())["mel"]
        with check.precision("fp8", net, tacotron):
            got = net(source, lengths, mel, torch.tensor([8]), generator=gen())["mel"]
        again = net(source, lengths, mel, torch.tensor([8]), generator=gen())["mel"]
    assert torch.equal(want, again)
    assert (got - want).abs().max() > 1e-3 * want.abs().max()


def test_seeded_weights_fill_both_sides():
    from self_attention_tacotron_torch import convert
    from self_attention_tacotron_torch.hparams import HParams
    from self_attention_tacotron_torch.models.models import TacotronNetwork

    hp = tiny.config("streaming")["hparams"]
    flat = ref_weights.draw_flat(hp, 5, "cpu")
    assert np.array_equal(flat["params/embedding/embedding"],
                          ref_weights.draw_flat(hp, 5, "cpu")["params/embedding/embedding"])
    port = TacotronNetwork(HParams().override_from_dict(hp))
    state = convert.flax_to_torch_state(flat, None, port)
    ref = tacotron.network(hp, flat, "cpu")
    assert set(state) == {k for k, _ in ref.state_dict().items()
                          if not k.endswith("num_batches_tracked")}
    for key, value in state.items():
        assert torch.equal(value, ref.state_dict()[key]), key
    table = {k: (kind, scale) for k, _, kind, scale in ref_weights.leaf_table(hp)}
    assert table["params/encoder/cbhg/highway_0/T/bias"] == ("const", -1.0)
    assert table["batch_stats/encoder/cbhg/proj1/BatchNorm_0/var"] == ("const", 1.0)
    assert [k for k, _ in ref.named_parameters()] == [k for k, _ in port.named_parameters()]
