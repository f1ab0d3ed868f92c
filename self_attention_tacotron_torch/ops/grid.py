"""How the grid kernels deal the output columns of their products out over the blocks
of a grid, for plans made without a card: the mirror of ``csrc/grid.cuh::share_of`` and
of ``plan_block`` in ``csrc/fused_decode.cu`` and ``csrc/fused_teacher.cu``, which use
the same formula."""

from __future__ import annotations

from typing import Dict, List, Tuple

# A block's slice of a product dealt to fewer blocks than the grid has stays within
# this many bytes (SLICE_BYTES of both kernels).
SLICE_BYTES = 8192


def round4(n: int) -> int:
    return (n + 3) // 4 * 4


def round8(n: int) -> int:
    return (n + 7) // 8 * 8


def share_of(n: int, blocks: int, r: int) -> Tuple[int, int]:
    """(first, count) of the items of the r-th of ``blocks`` blocks among which ``n``
    items are dealt out: every block gets n // blocks, the first n % blocks one more."""
    base, extra = divmod(n, blocks)
    return r * base + min(r, extra), base + (1 if r < extra else 0)


def deal(shapes: Dict[str, Tuple[int, int, bool]], n_sms: int, io_bytes: int,
         biases: bool) -> Tuple[Dict[str, int], List[Dict[str, Tuple[int, int, int]]],
                                List[int], List[int]]:
    """The kernels' plan of the products ``shapes`` (``{name: (K, items, gates)}`` in
    the order they run; items are output columns, or with ``gates`` units of four) on
    a grid of ``n_sms`` blocks: ``(blocks, slices, weight_bytes, bias_bytes)``.

    ``blocks[name]``: the blocks a product's items go to, as few as give each at least
    8 columns (2 units of a gate product) while a block's slice stays within
    ``SLICE_BYTES``, every block for a wide product. Its items are dealt in contiguous
    runs from block ``start`` on, and the next product starts where this one's blocks
    end (or, on every block, where its remainder ends). ``slices[b][name] = (first,
    count, columns)``; ``weight_bytes[b]`` block b's weight region (each slice's columns
    ``round8(K)`` values, the region rounded to 8 values after each product);
    ``bias_bytes[b]`` its float biases, ``round4(columns)`` a product, where ``biases``.
    """
    blocks = {}
    for name, (K, items, gates) in shapes.items():
        item_bytes = max(1, (4 if gates else 1) * round8(K) * io_bytes)
        per = max(1, min(2 if gates else 8, SLICE_BYTES // item_bytes))
        blocks[name] = min(n_sms, max(1, -(-items // per)))
    slices, weights, bias_bytes = [], [], []
    for b in range(n_sms):
        start, at, held, per_block = 0, 0, 0, {}
        for name, (K, items, gates) in shapes.items():
            used = blocks[name]
            r = (b - start) % n_sms
            first, count = share_of(items, used, r) if r < used else (0, 0)
            cols = 4 * count if gates else count
            per_block[name] = (first, count, cols)
            at = round8(at + cols * round8(K))
            held += round4(cols) if biases else 0
            start = (start + (used if used < n_sms else items % n_sms)) % n_sms
        slices.append(per_block)
        weights.append(at * io_bytes)
        bias_bytes.append(held * 4)
    return blocks, slices, weights, bias_bytes
