"""The cluster plan of the LSTM kernel: which block holds which units, which cluster
which lanes, and how many waves of clusters a batch takes.

``ops/fused_rnn.py::bilstm_plan`` (``rnn_plan`` of the LSTM kind) mirrors what
``csrc/bilstm.cu`` computes for itself (``csrc/cluster_rnn.cuh``: ``rnn_plan``,
``rnn_layout``). Every ZoneoutEncoderV1 width that a configuration of
``tools/flagship.py`` builds is planned in both io types at batches up to
``fused_decode.MAX_LANES``; so are the narrow widths the kernel is checked at. No card
is needed; ``chip_smoke.py`` holds the mirror against the built kernel's own numbers.
"""

import pytest
import torch

from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.models.modules import ZoneoutLSTMCell
from self_attention_tacotron_torch.ops import fused_rnn as fr
from self_attention_tacotron_torch.tools.flagship import CONFIGS, config_hparams

H100_SMS = 132
# clusters of 8 blocks (each asking for a whole SM's shared memory) resident at once on
# an H100 80GB HBM3, as the kernels' occupancy query reports it (chip_smoke.py's plan
# check): 15, not 132 // 8
H100_CLUSTERS_OF_8 = 15
IO = (torch.float32, torch.bfloat16)
BATCHES = (1, 8, 32, 128, 528, 1024)
# the widths of the kernel checks (chip_smoke.py): H below and off the cluster size
NARROW = ((10, 8), (7, 20))


def _lstm_widths(config):
    """(C, H) of every LSTM cell of the configuration's encoder (the decoders' LSTMs run
    inside the decode and teacher kernels)."""
    net = tacotron_model_factory(config_hparams(config)).network(device="cpu")
    return {(m.kernel_params()["kernel"].shape[0] - m.num_units, m.num_units)
            for m in net.encoder.modules() if isinstance(m, ZoneoutLSTMCell)}


def _configured_widths():
    widths = set()
    for config in CONFIGS:
        hp = config_hparams(config)
        if hp.encoder == "ZoneoutEncoderV1":
            widths |= _lstm_widths(config)
    return sorted(widths)


WIDTHS = sorted(set([(128, 128)] + list(NARROW)))
CASES = [(w, io, B) for w in WIDTHS for io in IO for B in BATCHES]


def _ids(case):
    (C, H), io, B = case
    return f"C{C}-H{H}-{str(io).split('.')[-1]}-B{B}"


def test_every_configured_encoder_lstm_width_is_planned():
    """Every ZoneoutEncoderV1 LSTM a configuration builds has a width the cases plan."""
    configured = _configured_widths()
    assert configured == [(128, 128)]
    assert set(configured) <= set(WIDTHS)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_plan_deals_units_and_lanes_once_fits_a_block_and_takes_the_fewest_waves(case):
    (C, H), io, B = case
    plan = fr.bilstm_plan(B, 128, C, H, io, n_sms=H100_SMS, active_clusters=H100_CLUSTERS_OF_8)
    assert plan.cluster == 8
    # a block's shared memory within what a block may have, and holding every buffer the
    # kernel keeps there: the i, g, f, o columns of its units, the copies of io(h), two
    # buffers of projection rows, the carries c and h and the io(h') it sends
    assert plan.smem_bytes <= fr.RNN_SMEM_LIMIT == plan.smem_limit == 232448
    io_bytes = 2 if io == torch.bfloat16 else 4
    u, Lp = plan.units_max, plan.lanes_padded
    least = 4 * u * H * io_bytes + 2 * Lp * H * 4 + Lp * (2 * 4 * u + 3 * u) * 4 + 4 * Lp + 16
    # a weight row is padded to 32 values (bfloat16: 64), a copy's row by at most 7
    assert least <= plan.smem_bytes <= least + 4 * u * 63 * io_bytes + 2 * Lp * 7 * 4 + 32
    assert plan.threads == fr.RNN_THREADS
    # every unit of a direction goes to exactly one block of each cluster
    units = plan.units(H)
    assert len(units) == plan.cluster
    owned = [j for first, count in units for j in range(first, first + count)]
    assert owned == list(range(H))
    assert max(count for _, count in units) == plan.units_max
    # every lane goes to exactly one cluster of each direction
    groups = plan.lane_groups(B)
    assert len(groups) == plan.groups and plan.clusters == 2 * plan.groups
    lanes = [b for first, count in groups for b in range(first, first + count)]
    assert lanes == list(range(B))
    assert max(count for _, count in groups) == plan.lanes <= plan.max_lanes
    assert plan.lanes_padded % plan.lane_tile == 0 and plan.lanes_padded >= plan.lanes
    assert plan.lane_tile == (1 if plan.lanes == 1 else 4)
    # max_lanes is the room of a block: that many lanes in one group fit, one more tile
    # of lanes does not
    assert fr.rnn_smem_bytes(H, u, plan.max_lanes, io_bytes, fr.RNN_LSTM) <= fr.RNN_SMEM_LIMIT
    assert fr.rnn_smem_bytes(H, u, plan.max_lanes + 4, io_bytes, fr.RNN_LSTM) > fr.RNN_SMEM_LIMIT
    # the clusters fit their waves, and no lane grouping could take fewer: counted over
    # every number of groups whose lanes fit a block, two directions a group and
    # `slots` clusters a wave
    assert plan.slots == H100_CLUSTERS_OF_8
    assert (plan.waves - 1) * plan.slots < plan.clusters <= plan.waves * plan.slots
    least_waves = min(-(-2 * g // plan.slots) for g in range(1, B + 1)
                      if -(-B // g) <= plan.max_lanes)
    assert plan.waves == least_waves
    if plan.waves == 1:
        assert plan.groups == min(B, plan.slots // 2)


@pytest.mark.parametrize("io", IO, ids=lambda io: str(io).split(".")[-1])
def test_the_encoder_width_takes_one_wave_on_an_h100_at_every_batch(io):
    """The plans the card runs at ZoneoutEncoderV1's width: 7 groups of 5 lanes (padded
    to 8) at B=32, one cluster a direction at B=1, B=528 in one wave of 14 clusters
    and B=1024 in two waves of 15 (the room of a block holds 112 lanes in float32, 120
    in bfloat16: 76 lanes a block, then 69)."""
    plan = fr.bilstm_plan(32, 128, 128, 128, io, n_sms=H100_SMS,
                          active_clusters=H100_CLUSTERS_OF_8)
    assert (plan.cluster, plan.units_max, plan.groups, plan.lanes, plan.lanes_padded,
            plan.clusters, plan.waves) == (8, 16, 7, 5, 8, 14, 1)
    one = fr.bilstm_plan(1, 97, 128, 128, io, n_sms=H100_SMS, active_clusters=H100_CLUSTERS_OF_8)
    assert (one.groups, one.lanes, one.lane_tile, one.clusters, one.waves) == (1, 1, 1, 2, 1)
    assert fr.bilstm_plan(32, 128, 128, 128, io).max_lanes == (112 if io == torch.float32 else 120)
    mid = fr.bilstm_plan(528, 128, 128, 128, io, n_sms=H100_SMS,
                         active_clusters=H100_CLUSTERS_OF_8)
    assert (mid.groups, mid.lanes, mid.clusters, mid.waves) == (7, 76, 14, 1)
    big = fr.bilstm_plan(1024, 128, 128, 128, io, n_sms=H100_SMS,
                         active_clusters=H100_CLUSTERS_OF_8)
    assert (big.groups, big.lanes, big.clusters, big.waves) == (15, 69, 30, 2)


def test_a_width_over_the_limit_raises_and_names_it():
    # a cluster of 16 holds H=384 in float32 (each block 24 units' four gate columns);
    # H=512 fits no block
    assert fr.bilstm_plan(8, 16, 384, 384, torch.float32).cluster == 16
    with pytest.raises(ValueError, match="bilstm: H=512 does not fit.*232448 bytes"):
        fr.bilstm_plan(8, 16, 512, 512, torch.float32)
