"""The plan of the full-sequence attention kernel: its grid, its tiles and a block's
shared memory, which must not grow with the sequence.

``ops/fused_attention.py::mha_full_plan`` mirrors what ``csrc/mha_full.cu`` computes
for itself (``mha_plan``). The flagship's encoder attention (D=256, 2 heads) and the
narrow widths the kernel is checked at are planned in both io types, at batches up to
``fused_decode.MAX_LANES`` and at sequences up to 8192 positions. No card is needed;
``chip_smoke.py`` holds the mirror against the built kernel's own numbers.
"""

import pytest
import torch

from self_attention_tacotron_torch.ops import fused_attention as fa
from self_attention_tacotron_torch.tools.flagship import config_hparams

IO = (torch.float32, torch.bfloat16)
BATCHES = (1, 8, 32, 128, 528, 1024)
# (D, heads): the flagship's encoder attention, the narrow checks (heads of 16 and 24
# values), one head of 256 (the widest the kernel holds), and 128 values in one head
WIDTHS = ((256, 2), (32, 2), (72, 3), (256, 1), (128, 1))
LENGTHS = (1, 97, 128, 3247, 8192)
CASES = [(w, io) for w in WIDTHS for io in IO]


def _ids(case):
    (D, H), io = case
    return f"D{D}-H{H}-{str(io).split('.')[-1]}"


def test_the_flagship_encoder_attention_is_planned():
    hp = config_hparams("flagship")
    assert (hp.self_attention_out_units, hp.self_attention_num_heads) in WIDTHS


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_plan_covers_every_row_fits_a_block_and_does_not_grow_with_t(case):
    (D, H), io = case
    es = 2 if io == torch.bfloat16 else 4
    plans = {(B, T): fa.mha_full_plan(B, T, D, H, io) for B in BATCHES for T in LENGTHS}
    smem = {p.smem_bytes for p in plans.values()}
    # one block's shared memory is the same at every T (and every B), within what a block
    # may have
    assert len(smem) == 1 and smem.pop() <= fa.MHA_SMEM_LIMIT == 232448
    for (B, T), p in plans.items():
        HD = D // H
        # one block per (tile of 64 query rows, head, lane): every row of every head once
        assert (p.grid_x, p.grid_y, p.grid_z) == (-(-T // 64), H, B)
        assert p.rows == p.keys == 64 and p.threads == 256 and p.hd == HD
        assert p.grid_x * p.rows >= T > (p.grid_x - 1) * p.rows
        # the head padded to the product's tile (bfloat16: 32 values, two n tiles of the
        # tensor cores a half-warp; float32: 8), rows padded off the banks
        assert p.hd_padded >= HD and p.hd_padded % (32 if es == 2 else 8) == 0
        assert p.hd_padded - HD < (32 if es == 2 else 8)
        assert p.ld * es % 16 == 0 and (p.ld * es // 16) % 2 == 1
        assert p.pld * es % 16 == 0 and (p.pld * es // 16) % 2 == 1
        # the block holds q rows, two K/V tiles, the io(p) tile, the rows' maxima and sums
        # and, where lk > 0, lk keys of logits a row; lk is a multiple of 64 up to 512,
        # the most that fit
        held = 64 * p.ld * es + 2 * 64 * p.ld * es + 64 * p.pld * es + 8 * 64
        assert held <= p.smem_bytes
        assert p.lk % 64 == 0 and 0 <= p.lk <= fa.MHA_LK_MAX
        if p.lk > 0:
            assert p.smem_bytes >= held + 4 * 64 * (p.lk + 16)
        if p.lk < fa.MHA_LK_MAX:
            assert p.smem_bytes - 4 * 64 * ((p.lk + 16) if p.lk else 0) + 4 * 64 * (p.lk + 64 + 16) \
                > fa.MHA_SMEM_LIMIT
        # the logits stay on chip exactly where T fits the room
        assert p.on_chip == int(T <= p.lk)


@pytest.mark.parametrize("io", IO, ids=lambda io: str(io).split(".")[-1])
def test_the_flagship_shape_keeps_its_logits_on_chip_and_long_sequences_launch(io):
    """At the flagship's shape (B=32, T=128) 128 blocks, one wave of an H100, the
    logits on chip; at T=3247 (beyond which the old design could not launch) and 8192
    the same shared memory, the logits in probs' rows."""
    p = fa.mha_full_plan(32, 128, 256, 2, io)
    assert (p.grid_x * p.grid_y * p.grid_z, p.on_chip) == (128, 1)
    assert p.lk == (384 if io == torch.float32 else 512)
    for T in (3247, 8192):
        q = fa.mha_full_plan(1, T, 256, 2, io)
        assert (q.on_chip, q.smem_bytes) == (0, p.smem_bytes)


@pytest.mark.parametrize("io", IO, ids=lambda io: str(io).split(".")[-1])
def test_a_head_over_the_limit_raises_and_names_it(io):
    assert fa.mha_full_plan(1, 16, 256, 1, io).hd == fa.MHA_HD_MAX == 256
    with pytest.raises(ValueError, match="MHA_HD_MAX = 256"):
        fa.mha_full_plan(1, 16, 512, 1, io)
    # the plain version, which a CPU tensor takes, holds any head (chip_smoke.py holds
    # the wrapper on the card to the ValueError, with no launch)
    ctx, probs = fa.mha_full(torch.zeros(1, 4, 3 * 512, dtype=io), None, 1)
    assert ctx.shape == (1, 4, 512) and probs.shape == (1, 1, 4, 4)
