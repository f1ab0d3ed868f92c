"""Observability: alignment/mel PNG artifacts + scalar metric writers.

Counterpart of the JAX package's ``training/metrics.py``: at eval and save
steps, render attention alignment matrices (one panel per attention source)
and predicted-vs-target mel comparisons to PNG, and log scalar training
metrics. Scalars go to a JSONL log (the same records as the JAX package's)
and, where the ``tensorboard`` package is installed, to event files through
``torch.utils.tensorboard``.

The PNGs are drawn with matplotlib where it is installed (imported inside the
functions, never at module import). Without it they are written as plain
8-bit greyscale PNGs of the same arrays (no axes, no labels; zlib and struct):
each panel min-max scaled to 0..255, the first axis of the matrix drawn bottom
to top as matplotlib's ``origin="lower"`` does, panels side by side (alignments)
or stacked with the prediction on top (mels). ``image_writer()`` says which one
serves.
"""

from __future__ import annotations

import importlib.util
import json
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np


def image_writer() -> str:
    """``"matplotlib"`` where it can be imported, else ``"greyscale"``."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return "greyscale"
    return "matplotlib"


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# --------------------------------------------------------------------------- #
# The PNG writer without matplotlib
# --------------------------------------------------------------------------- #


def grey_levels(matrix: np.ndarray) -> np.ndarray:
    """A matrix as 8-bit grey levels: min-max scaled to 0..255, rounded. A
    constant matrix is 0."""
    a = np.asarray(matrix, np.float64)
    lo, hi = (float(a.min()), float(a.max())) if a.size else (0.0, 0.0)
    scaled = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    return np.round(scaled * 255.0).astype(np.uint8)


def panel_image(matrix: np.ndarray) -> np.ndarray:
    """The grey image of one panel: ``matrix.T`` with its first row at the
    bottom (matplotlib's ``imshow(matrix.T, origin="lower")``)."""
    return grey_levels(np.asarray(matrix, np.float32).T)[::-1]


def write_grey_png(path: str, image: np.ndarray) -> None:
    """Write a (height, width) uint8 array as an 8-bit greyscale PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    height, width = image.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8), image], axis=1)  # filter 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _side_by_side(images: List[np.ndarray]) -> np.ndarray:
    height = max(im.shape[0] for im in images)
    padded = [np.pad(im, ((height - im.shape[0], 0), (0, 0))) for im in images]
    return np.concatenate(padded, axis=1)


def _stacked(images: List[np.ndarray]) -> np.ndarray:
    width = max(im.shape[1] for im in images)
    return np.concatenate([np.pad(im, ((0, 0), (0, width - im.shape[1]))) for im in images])


# --------------------------------------------------------------------------- #
# The artifacts
# --------------------------------------------------------------------------- #


def _alignment_panels(alignments, source_length, decoder_steps) -> List[np.ndarray]:
    panels = []
    for align in alignments:
        # float32: matplotlib renders bfloat16 arrays as a blank panel
        a = np.asarray(align, np.float32)
        if decoder_steps:
            a = a[:decoder_steps]
        if source_length:
            a = a[:, :source_length]
        panels.append(a)
    return panels


def save_alignment_png(
    alignments: Sequence[np.ndarray],   # per source: (dec_steps, src_len)
    path: str,
    *,
    info: str = "",
    source_length: Optional[int] = None,
    decoder_steps: Optional[int] = None,
) -> None:
    panels = _alignment_panels(alignments, source_length, decoder_steps)
    if image_writer() == "greyscale":
        write_grey_png(path, _side_by_side([panel_image(a) for a in panels]))
        return
    plt = _pyplot()
    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 4), squeeze=False)
    for i, a in enumerate(panels):
        im = axes[0][i].imshow(a.T, aspect="auto", origin="lower", interpolation="none")
        axes[0][i].set_xlabel("decoder step")
        axes[0][i].set_ylabel("encoder position")
        axes[0][i].set_title(f"source {i}")
        fig.colorbar(im, ax=axes[0][i])
    if info:
        fig.suptitle(info)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)


def save_mel_comparison_png(
    predicted: np.ndarray,              # (T, num_mels)
    target: Optional[np.ndarray],
    path: str,
    *,
    info: str = "",
    length: Optional[int] = None,
) -> None:
    panels = [np.asarray(predicted, np.float32)]
    if target is not None:
        panels.append(np.asarray(target, np.float32))
    if length:
        panels = [p[:length] for p in panels]
    if image_writer() == "greyscale":
        write_grey_png(path, _stacked([panel_image(p) for p in panels]))
        return
    plt = _pyplot()
    fig, axes = plt.subplots(len(panels), 1, figsize=(10, 3 * len(panels)), squeeze=False)
    for row, (panel, title) in enumerate(zip(panels, ("predicted mel", "target mel"))):
        axes[row][0].imshow(panel.T, aspect="auto", origin="lower", interpolation="none")
        axes[row][0].set_title(title)
    if info:
        fig.suptitle(info)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)


class MetricsWriter:
    """JSONL scalar log + TensorBoard event files where ``tensorboard`` is installed."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard and importlib.util.find_spec("tensorboard") is not None:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        print(f"metrics: scalars to metrics.jsonl{' and TensorBoard' if self._tb else ''}, "
              f"images by {image_writer()}, in {log_dir}", flush=True)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(key, float(value), int(step))
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
