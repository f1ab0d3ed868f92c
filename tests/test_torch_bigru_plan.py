"""The cluster plan of the BiGRU kernels: which block holds which units, which
cluster which lanes, and how many waves of clusters a batch takes.

``ops/fused_rnn.py::bigru_plan`` mirrors what ``csrc/bigru.cu`` (forward) and
``csrc/bigru_bwd.cu`` (backward) compute for themselves (``csrc/cluster_rnn.cuh``:
``rnn_plan``, ``rnn_layout``). Every CBHG width that a configuration of
``tools/flagship.py`` or ``configs/*.json`` builds (the encoder's and PostCBHG's) is
planned in both io types and both directions of autograd, at batches up to
``fused_decode.MAX_LANES``; so are the narrow widths the kernels are checked at, and
PostCBHG's BiGRU over a whole ``streaming`` request (B = 64, S = max_iters * r = 2400).
No card is needed; ``chip_smoke.py`` holds the mirror against the built kernels' own
numbers.
"""

import glob
import os

import pytest
import torch

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.models import tacotron_model_factory
from self_attention_tacotron_torch.models.modules import GRUCell
from self_attention_tacotron_torch.ops import fused_rnn as fr
from self_attention_tacotron_torch.tools.flagship import CONFIGS, config_hparams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_SMS = 132
# clusters of 8 blocks (each asking for a whole SM's shared memory) resident at once on
# an H100 80GB HBM3, as the kernels' occupancy query reports it (chip_smoke.py's plan
# check): 15, not 132 // 8
H100_CLUSTERS_OF_8 = 15
IO = (torch.float32, torch.bfloat16)
BATCHES = (1, 8, 32, 128, 528, 1024)
# the widths of the kernel checks (tests/test_torch_fused_rnn.py, chip_smoke.py):
# H below and off the cluster size
NARROW = ((10, 8), (7, 20))


def _gru_widths(hp: HParams):
    """(C, H) of every GRU cell of the configuration's network: the encoder's CBHG and,
    with the linear postnet, PostCBHG's."""
    net = tacotron_model_factory(hp).network(device="cpu")
    return {(m.kernel_params()["gates_kernel"].shape[0] - m.num_units, m.num_units)
            for m in net.modules() if isinstance(m, GRUCell)}


def _configured_widths():
    widths = set()
    for config in CONFIGS:
        widths |= _gru_widths(config_hparams(config))
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))):
        widths |= _gru_widths(HParams().override_from_json_file(path))
    return sorted(widths)


WIDTHS = sorted(set([(128, 128)] + list(NARROW)))
CASES = [(w, io, bwd, B) for w in WIDTHS for io in IO for bwd in (False, True) for B in BATCHES]


def _ids(case):
    (C, H), io, backward, B = case
    return f"C{C}-H{H}-{str(io).split('.')[-1]}-{'bwd' if backward else 'fwd'}-B{B}"


def test_every_configured_cbhg_width_is_planned():
    """Every BiGRU a configuration builds has a width the cases below plan; PostCBHG's
    (``streaming``) is the encoder's, 128 units over 128 channels after ``highway_in``."""
    configured = _configured_widths()
    assert configured == [(128, 128)]
    assert set(configured) <= set(WIDTHS)
    post = tacotron_model_factory(config_hparams("streaming")).network(device="cpu").post_cbhg
    assert _gru_widths(config_hparams("streaming")) == {(128, 128)}
    assert post.cbhg.birnn.use_pallas and post.cbhg.highway_in.out_features == 128


@pytest.mark.parametrize("io", IO, ids=lambda io: str(io).split(".")[-1])
@pytest.mark.parametrize("backward", (False, True), ids=("fwd", "bwd"))
def test_post_cbhg_over_a_streaming_request_takes_one_wave(io, backward):
    """PostCBHG's BiGRU over a whole ``streaming`` request: 64 lanes of up to
    max_iters * r = 2400 frames. The plan does not depend on S (a block holds no step's
    rows beyond the current one): 64 lanes in 7 groups of up to 10 (padded to 12), 14
    clusters, one wave; the input projection's scratch is B * S * 6H floats."""
    hp = config_hparams("streaming")
    S = hp.max_iters * hp.outputs_per_step
    assert (hp.batch_size, S) == (64, 2400)
    plan = fr.bigru_plan(64, S, 128, 128, io, n_sms=H100_SMS, backward=backward,
                         active_clusters=H100_CLUSTERS_OF_8)
    assert plan == fr.bigru_plan(64, 97, 128, 128, io, n_sms=H100_SMS, backward=backward,
                                 active_clusters=H100_CLUSTERS_OF_8)
    assert (plan.cluster, plan.groups, plan.lanes, plan.lanes_padded, plan.clusters,
            plan.waves) == (8, 7, 10, 12, 14, 1)
    assert plan.smem_bytes <= fr.RNN_SMEM_LIMIT
    assert 64 * S * 6 * 128 * 4 == 471_859_200


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_plan_deals_units_and_lanes_once_fits_a_block_and_takes_the_fewest_waves(case):
    (C, H), io, backward, B = case
    plan = fr.bigru_plan(B, 128, C, H, io, n_sms=H100_SMS, backward=backward,
                         active_clusters=H100_CLUSTERS_OF_8)
    assert plan.cluster == 8
    # a block's shared memory within what a block may have, and holding every buffer
    # the kernel keeps there: the weight slice, the gathered inputs and the per-lane rows
    assert plan.smem_bytes <= fr.RNN_SMEM_LIMIT == plan.smem_limit == 232448
    io_bytes = 2 if io == torch.bfloat16 else 4
    u, Lp = plan.units_max, plan.lanes_padded
    if backward:   # Wc_h^T, Wg_h^T; io(g_ac), io(g_ag); two buffers of 5 rows, g, g_h, g_rh, 2u
        weights, gathered, own = u * 3 * H * io_bytes, Lp * 3 * H * 4, Lp * (2 * 5 * u + 5 * u) * 4
    else:          # Wg_h, Wc_h; io(h), io(r*h); two buffers of 3 rows, the carry
        weights, gathered, own = 3 * u * H * io_bytes, Lp * 2 * H * 4, Lp * (2 * 3 * u + u) * 4
    least = weights + gathered + own + 4 * Lp + 16
    # each weight and gathered row is padded by at most 7 values (to 4, then 4 more)
    rows = (3 * u if not backward else 2 * u) + (2 * Lp if not backward else 2 * Lp)
    assert least <= plan.smem_bytes <= least + rows * 7 * 4 + 16 + 8
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
    # of lanes does not (the layout's bytes, which chip_smoke.py holds to the kernel's)
    full = fr.bigru_plan(plan.max_lanes, 128, C, H, io, backward=backward, active_clusters=2)
    assert full.groups == 1 and full.smem_bytes <= fr.RNN_SMEM_LIMIT
    assert fr.rnn_smem_bytes(H, u, full.lanes_padded + 4, io_bytes, backward) > fr.RNN_SMEM_LIMIT
    # the clusters fit their waves, and no lane grouping could take fewer: counted over
    # every number of groups whose lanes fit a block, two directions a group and
    # `slots` clusters a wave
    assert plan.slots == H100_CLUSTERS_OF_8
    assert (plan.waves - 1) * plan.slots < plan.clusters <= plan.waves * plan.slots
    least = min(-(-2 * g // plan.slots) for g in range(1, B + 1)
                if -(-B // g) <= plan.max_lanes)
    assert plan.waves == least
    # a batch that one wave holds spreads over as many clusters as it has lanes, up to
    # the wave's
    if plan.waves == 1:
        assert plan.groups == min(B, plan.slots // 2)


@pytest.mark.parametrize("io", IO, ids=lambda io: str(io).split(".")[-1])
@pytest.mark.parametrize("backward", (False, True), ids=("fwd", "bwd"))
def test_the_flagship_width_takes_one_wave_on_an_h100_at_b32_and_b1(io, backward):
    """The plans the card runs at the flagship's width (chip_smoke.py prints them): at
    B=32, 7 groups of 5 lanes (padded to 8) in 14 of the 15 resident clusters."""
    plan = fr.bigru_plan(32, 128, 128, 128, io, n_sms=H100_SMS, backward=backward,
                         active_clusters=H100_CLUSTERS_OF_8)
    assert (plan.cluster, plan.units_max, plan.groups, plan.lanes, plan.lanes_padded,
            plan.clusters, plan.waves) == (8, 16, 7, 5, 8, 14, 1)
    one = fr.bigru_plan(1, 97, 128, 128, io, n_sms=H100_SMS, backward=backward,
                        active_clusters=H100_CLUSTERS_OF_8)
    assert (one.groups, one.lanes, one.lane_tile, one.clusters, one.waves) == (1, 1, 1, 2, 1)


def test_the_card_s_own_cluster_count_is_taken_as_given():
    """On the card the plan takes the resident clusters that the kernel's occupancy
    query reports (chip_smoke.py passes them); fewer slots, more waves or lanes."""
    plan = fr.bigru_plan(1024, 128, 128, 128, torch.float32, n_sms=H100_SMS, active_clusters=14)
    assert (plan.slots, plan.waves, plan.groups, plan.lanes) == (14, 2, 14, 74)
    plan = fr.bigru_plan(1024, 128, 128, 128, torch.float32, n_sms=H100_SMS,
                         active_clusters=H100_CLUSTERS_OF_8)
    assert (plan.slots, plan.waves, plan.groups, plan.lanes) == (15, 2, 15, 69)
    # without the card's count, one cluster of 8 an eighth of the SMs
    assert fr.bigru_plan(1024, 128, 128, 128, torch.float32, n_sms=H100_SMS).waves == 1


@pytest.mark.parametrize("backward", (False, True), ids=("fwd", "bwd"))
def test_a_width_over_the_limit_raises_and_names_it(backward):
    # a cluster of 16 holds H=512 in float32 in both directions; H=1024 fits no block
    assert fr.bigru_plan(8, 16, 512, 512, torch.float32, backward=backward).cluster == 16
    with pytest.raises(ValueError, match="232448 bytes"):
        fr.bigru_plan(8, 16, 1024, 1024, torch.float32, backward=backward)
