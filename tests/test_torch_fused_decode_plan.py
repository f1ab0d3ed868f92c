"""The grid plan of ``fused_decode``'s kernel: which block holds which weights.

``ops/fused_decode.py::grid_plan`` mirrors what ``csrc/fused_decode.cu`` computes
itself (``plan_block``, ``smem_layout``): every configuration of
``tools/flagship.py`` in both io types, on an H100 SXM (132 SMs) and an H100 PCIe
(114 SMs). No card is needed; ``chip_smoke.py`` holds the mirror against the built
kernel's own numbers.
"""

import inspect

import pytest
import torch

from self_attention_tacotron_torch.models.models import TacotronNetwork
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.tools.flagship import CONFIGS, config_hparams

SMS = (132, 114)
IO = (torch.float32, torch.bfloat16)
# forced-alignment mode decodes with the step-by-step loop (the kernel does not serve it)
DECODED = [c for c in CONFIGS if c != "forced"]
CASES = [(c, io, n) for c in DECODED for io in IO for n in SMS]


def _ids(case):
    config, io, sms = case
    return f"{config}-{str(io).split('.')[-1]}-{sms}"


def _plan(config, io, sms):
    hp = config_hparams(config, compute_dtype="bfloat16" if io == torch.bfloat16 else "float32")
    sizes = fd._hp_sizes(hp)
    return hp, sizes, fd.grid_plan(sizes, sms, io)


def test_every_configuration_is_planned():
    assert set(CONFIGS) == {"flagship", "baseline", "zoneout", "ls", "flagship-ls", "mgclf0",
                            "flagship-mgclf0", "mgclf0-ls", "flagship-mgclf0-ls",
                            "flagship-dualsource-ls", "streaming", "vctk", "japanese", "forced"}
    for config in DECODED:
        assert fd.supports_fused_decode(config_hparams(config)), config
    assert not fd.supports_fused_decode(config_hparams("forced"))
    # streaming's output stage: R * M + R = 243 columns at r = 3
    z = fd._hp_sizes(config_hparams("streaming"))
    assert (z["R"], z["M"]) == (3, 80)
    assert fd.product_shapes(z)["out"][1] == 3 * 80 + 3


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_every_output_column_has_exactly_one_owner(case):
    _, sizes, plan = _plan(*case)
    assert plan.n_blocks == case[2] and len(plan.slices) == case[2]
    for name, (K, items, gates) in fd.product_shapes(sizes).items():
        width = 4 * items if gates else items
        cols = plan.columns(name, sizes)
        assert sorted(cols) == list(range(width)), name
        counts = [per_block[name][1] for per_block in plan.slices if per_block[name][1]]
        assert len(counts) <= plan.blocks[name] <= case[2], name
        if items:
            assert len(counts) == plan.blocks[name], name
            assert max(counts) - min(counts) <= 1, name   # dealt out evenly


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_four_gate_columns_of_a_unit_share_a_block(case):
    _, sizes, plan = _plan(*case)
    for name, (K, items, gates) in fd.product_shapes(sizes).items():
        if not gates:
            continue
        owner = {}
        for b, per_block in enumerate(plan.slices):
            first, count, cols = per_block[name]
            assert cols == 4 * count
            for unit in range(first, first + count):
                for g in range(4):
                    owner[g * items + unit] = b
        for unit in range(items):
            assert len({owner[g * items + unit] for g in range(4)}) == 1, (name, unit)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_a_block_fits_the_shared_memory_of_an_sm(case):
    config, io, sms = case
    _, sizes, plan = _plan(*case)
    item = 2 if io == torch.bfloat16 else 4
    ldk = fd._round8   # the stride of the rows in global memory
    resident = [
        sum(per_block[name][2] * ldk(K) * item
            for name, (K, _, _) in fd.product_shapes(sizes).items())
        for per_block in plan.slices
    ]
    # a block's weight region holds its slices, each padded to eight values at most
    for held, region in zip(resident, plan.weight_bytes):
        assert held <= region <= held + 8 * item * len(fd.PRODUCTS)
    rows = 4 * max(ldk(K) for K, items, _ in fd.product_shapes(sizes).values() if items)
    assert plan.smem_bytes >= max(plan.weight_bytes) + rows * item
    assert plan.smem_bytes + fd.STATIC_SMEM <= fd.H100_BLOCK_SMEM, config
    # the weights are spread over the whole grid, not held by a few blocks; a product
    # dealt to fewer blocks keeps each slice of it within SLICE_BYTES
    assert max(plan.weight_bytes) <= 1.25 * sum(plan.weight_bytes) / sms
    for name, (K, items, gates) in fd.product_shapes(sizes).items():
        if plan.blocks[name] < sms:
            most = max(per_block[name][2] for per_block in plan.slices)
            assert most * ldk(K) * item <= fd.SLICE_BYTES, name


def test_small_products_go_to_fewer_blocks_and_wide_ones_to_every_block():
    """At the flagship's widths the query projection (256 columns) goes to 32 blocks of
    8 columns, the attention LSTM (256 units, 3.5 KB a unit in float32) to all 132."""
    sizes = fd._hp_sizes(config_hparams("flagship"))
    plan = fd.grid_plan(sizes, 132, torch.float32)
    assert plan.blocks["qp"] == 32 and plan.blocks["p2"] == 16
    assert plan.blocks["attg"] == plan.blocks["l1"] == 132


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_launch_limit_is_what_fused_decode_max_batch_reports_without_a_card(case):
    config, io, sms = case
    hp, sizes, plan = _plan(*case)
    assert not torch.cuda.is_available()
    assert plan.max_lanes == fd.MAX_LANES
    assert fd.fused_decode_max_batch(hp) == fd.grid_plan(sizes, fd.H100_SM_COUNT, io).max_lanes


def test_a_block_that_cannot_fit_gives_no_launch():
    """The flagship's weights spread over a quarter of an H100's SMs outgrow a block;
    the source length does not grow it (the alignment stage walks the source in
    tiles of ATT_TILE positions), so no length can."""
    sizes = fd._hp_sizes(config_hparams("flagship"))
    assert fd.grid_plan(sizes, 132, torch.float32).max_lanes == fd.MAX_LANES
    assert fd.grid_plan(sizes, 33, torch.float32).max_lanes == 0
    assert "src_len" not in inspect.signature(fd.grid_plan).parameters


@pytest.mark.parametrize("config", DECODED)
def test_the_plan_reads_the_shapes_the_decoder_packs(config):
    """Each product's depth and width are those of the packed matrix it multiplies by."""
    hp = config_hparams(config)
    torch.manual_seed(0)
    packed = fd.pack_decoder(TacotronNetwork(hp).decoder.eval())
    assert fd._hp_sizes(hp) == packed.sizes
    for name, (K, items, gates) in fd.product_shapes(packed.sizes).items():
        rows, cols = packed.shapes[f"{name}_w"]
        if items == 0:
            assert (rows, cols) == (0, 0), name
        else:
            assert (rows, cols) == (K, 4 * items if gates else items), name
    assert fd.stages(packed.use_sa)[-1] == "out"
    assert len(fd.stages(packed.use_sa)) == (15 if packed.use_sa else 9)


# The location-sensitive configurations, whose folded location matrix (and WORLD
# frames) grow a block: each fits an H100 SXM's SM in both io types, whatever the
# source length.
LS_CONFIGS = [(c, io) for c in ("flagship-ls", "mgclf0-ls", "flagship-mgclf0-ls",
                                "flagship-dualsource-ls")
              for io in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("config,io", LS_CONFIGS, ids=lambda v: str(v).split(".")[-1])
def test_a_location_sensitive_block_fits_at_any_source_length(config, io):
    hp = config_hparams(config, compute_dtype="bfloat16" if io == torch.bfloat16 else "float32")
    plan = fd.grid_plan(fd._hp_sizes(hp), fd.H100_SM_COUNT, io)
    assert plan.max_lanes == fd.MAX_LANES
    assert fd.fused_decode_max_batch(hp) == fd.MAX_LANES
