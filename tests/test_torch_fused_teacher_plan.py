"""The grid plan of the teacher-forced decoder kernels: which block holds which weights.

``ops/fused_teacher.py::teacher_grid_plan`` mirrors what ``csrc/fused_teacher.cu``
computes itself (``plan_block``, ``smem_layout``) for each of its 16 instantiations
(two sources or one, forward or location-sensitive attention, float32 or bfloat16,
forward or backward): the configurations of ``tools/flagship.py`` reach every
structure, and each is planned at its own widths in both io types and both
directions. No card is needed; ``chip_smoke.py`` holds the mirror against the built
kernels' own numbers.
"""

import pytest
import torch

from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.ops import fused_teacher as ft
from self_attention_tacotron_torch.tools.flagship import CONFIGS, config_hparams

IO = (torch.float32, torch.bfloat16)
CASES = [(c, io, bwd) for c in CONFIGS for io in IO for bwd in (False, True)]
BATCHES = (1, 8, 32, 64, 128)
SOURCES = (128, 1100)
N = 400
H100_MEMORY = 80 * 2**30


def _ids(case):
    config, io, backward = case
    return f"{config}-{str(io).split('.')[-1]}-{'bwd' if backward else 'fwd'}"


def _sizes(config):
    # the kernels' sizes of the configuration (the decode kernel's, which its own
    # tests hold against the packed decoder, restricted to the scanned region's)
    z = fd._hp_sizes(config_hparams(config))
    return {k: z[k] for k in ("P2", "SPK", "AU", "A1", "A2", "DU", "E1", "E2", "K")}


def test_the_configurations_reach_every_instantiation():
    """Two sources or one, forward or location-sensitive attention: each structure
    of the kernels is some configuration's (and each in both io types and
    directions below)."""
    structures = {(_sizes(c)["E2"] > 0, _sizes(c)["K"] > 0) for c in CONFIGS}
    assert structures == {(True, False), (False, False), (True, True), (False, True)}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_plan_owns_every_column_once_fits_a_block_and_refuses_no_served_shape(
        case, monkeypatch):
    config, io, backward = case
    z = _sizes(config)
    plan = ft.teacher_grid_plan(z, fd.H100_SM_COUNT, io, backward)
    assert plan.n_blocks == fd.H100_SM_COUNT == len(plan.slices)
    shapes = ft.teacher_product_shapes(z, backward)
    assert tuple(shapes) == ft.PRODUCTS[backward]
    item = 2 if io == torch.bfloat16 else 4
    for name, (K, items, gates) in shapes.items():
        # every output column has exactly one owner, the items dealt out evenly
        width = 4 * items if gates else items
        assert sorted(plan.columns(name, z)) == list(range(width)), name
        counts = [per_block[name][1] for per_block in plan.slices if per_block[name][1]]
        assert len(counts) == plan.blocks[name] <= plan.n_blocks, name
        assert max(counts) - min(counts) <= 1, name
        # the four gate columns of a unit share a block
        if gates:
            owner = {}
            for b, per_block in enumerate(plan.slices):
                first, count, cols = per_block[name]
                assert cols == 4 * count
                for unit in range(first, first + count):
                    for g in range(4):
                        owner[g * items + unit] = b
            assert all(len({owner[g * items + u] for g in range(4)}) == 1 for u in range(items))
        # a product dealt to fewer blocks keeps each slice within SLICE_BYTES
        if plan.blocks[name] < plan.n_blocks:
            most = max(per_block[name][2] for per_block in plan.slices)
            assert most * ft._round8(K) * item <= ft.SLICE_BYTES, name
    # a block's weight region holds its slices, each padded to eight values at most,
    # and the weights are spread over the whole grid
    for per_block, region in zip(plan.slices, plan.weight_bytes):
        held = sum(per_block[name][2] * ft._round8(K) * item
                   for name, (K, _, _) in shapes.items())
        assert held <= region <= held + 8 * item * len(shapes)
    assert max(plan.weight_bytes) <= 1.25 * sum(plan.weight_bytes) / plan.n_blocks + 8192
    # one block fits the shared memory of an H100 SM (227 KB), with room for at
    # least one group of four lanes' rows of the widest product
    assert plan.fits and plan.smem_bytes + ft.STATIC_SMEM <= ft.H100_BLOCK_SMEM == 232448
    widest = max(ft._round8(K) for K, _, _ in shapes.values())
    assert plan.work_bytes >= 4 * widest * item
    assert plan.smem_bytes == plan.resident_bytes + plan.work_bytes
    assert plan.lanes_per_copy >= 4 and plan.lanes_per_copy % 4 == 0

    # no served shape is refused: the plan takes neither lanes nor source length,
    # and at every batch and source length the rows of one launch pair fit the
    # share of an 80 GB card that teacher_max_batch allows
    class Card:
        total_memory = H100_MEMORY

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Card)
    z_rows = dict(z, CUM=int(z["K"] > 0))
    for S in SOURCES:
        lanes = ft.teacher_max_batch(z_rows, S, N, "card", io)
        for B in BATCHES:
            assert B <= lanes, (S, B, lanes)
