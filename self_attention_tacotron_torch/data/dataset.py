"""Input pipeline: per-utterance TFRecord pairs -> padded batches.

The port's own copy of the JAX package's ``data/dataset.py`` (it is numpy and
threading already), so a batch of the port equals the JAX package's for the
same corpus and seed: same ids, same arrays, same order.

* parse ``<id>.source.tfrecord`` / ``<id>.target.tfrecord`` pairs,
* zip source+target, filter by ``--selected-list-dir`` id lists,
* synthesize stop-token ("done") targets (0 until the last frame, 1 at
  and after it),
* pad target frames to a multiple of the reduction factor
  ``outputs_per_step``,
* length-bucketed padded batching with shuffling and prefetch.

Every batch is padded to quantized shapes (source length and frame count
rounded up to bucket boundaries), so the model sees a few shapes rather than
one per batch. Batching is plain numpy on the host with a background prefetch
thread.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from self_attention_tacotron_torch.utils import tfrecord as tfr


# --------------------------------------------------------------------------- #
# Record schemas (field names are the public corpus format)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class SourceData:
    id: str
    text: str
    source: np.ndarray                      # (S,) int64 symbol ids
    source_length: int
    speaker_id: int = 0
    accent_type: Optional[np.ndarray] = None  # (S,) int64, aligned to source


@dataclasses.dataclass
class TargetData:
    id: str
    target_length: int
    mel: Optional[np.ndarray] = None        # (T, num_mels) float32
    spec: Optional[np.ndarray] = None       # (T, num_freq) float32
    mgc: Optional[np.ndarray] = None        # (T, num_mgcs) float32
    lf0: Optional[np.ndarray] = None        # (T,) int64 quantized


def write_source_tfrecord(path: str, data: SourceData) -> None:
    feats = {
        "id": data.id.encode("utf-8"),
        "text": data.text.encode("utf-8"),
        "source": np.asarray(data.source, np.int64),
        "source_length": np.asarray([data.source_length], np.int64),
        "speaker_id": np.asarray([data.speaker_id], np.int64),
    }
    if data.accent_type is not None:
        feats["accent_type"] = np.asarray(data.accent_type, np.int64)
    tfr.write_example_file(path, feats)


def write_target_tfrecord(path: str, data: TargetData) -> None:
    feats: Dict[str, tfr.FeatureValue] = {
        "id": data.id.encode("utf-8"),
        "target_length": np.asarray([data.target_length], np.int64),
    }
    for name in ("mel", "spec", "mgc"):
        arr = getattr(data, name)
        if arr is not None:
            arr = np.asarray(arr, np.float32)
            feats[name] = arr.reshape(-1)
            feats[f"{name}_width"] = np.asarray([arr.shape[1]], np.int64)
    if data.lf0 is not None:
        feats["lf0"] = np.asarray(data.lf0, np.int64)
    tfr.write_example_file(path, feats)


def parse_source_tfrecord(path: str) -> SourceData:
    f = tfr.read_example_file(path)
    return SourceData(
        id=f["id"].decode("utf-8"),
        text=f.get("text", b"").decode("utf-8"),
        source=np.asarray(f["source"], np.int64),
        source_length=int(f["source_length"][0]),
        speaker_id=int(f["speaker_id"][0]) if "speaker_id" in f else 0,
        accent_type=np.asarray(f["accent_type"], np.int64) if "accent_type" in f else None,
    )


def parse_target_tfrecord(path: str) -> TargetData:
    f = tfr.read_example_file(path)
    out = TargetData(
        id=f["id"].decode("utf-8"), target_length=int(f["target_length"][0])
    )
    for name in ("mel", "spec", "mgc"):
        if name in f:
            width = int(f[f"{name}_width"][0])
            setattr(out, name, np.asarray(f[name], np.float32).reshape(-1, width))
    if "lf0" in f:
        out.lf0 = np.asarray(f["lf0"], np.int64)
    return out


# --------------------------------------------------------------------------- #
# Batch construction helpers
# --------------------------------------------------------------------------- #


def make_done_targets(length: int, padded_length: int) -> np.ndarray:
    """Stop-token targets: 0 before the last frame, 1 at and after it."""
    done = np.zeros((padded_length,), np.float32)
    done[max(length - 1, 0):] = 1.0
    return done


def pad_to_multiple(frames: np.ndarray, multiple: int) -> np.ndarray:
    t = frames.shape[0]
    pad = (-t) % multiple
    if pad == 0:
        return frames
    return np.pad(frames, [(0, pad)] + [(0, 0)] * (frames.ndim - 1))


def read_selected_list(selected_list_dir: str, name: str) -> List[str]:
    """Read utterance ids from ``<dir>/<name>.{lst,txt,csv}`` (one per line)."""
    for ext in ("lst", "txt", "csv"):
        path = os.path.join(selected_list_dir, f"{name}.{ext}")
        if os.path.exists(path):
            with open(path) as f:
                return [line.strip().split(",")[0] for line in f if line.strip()]
    raise FileNotFoundError(
        f"no selected list {name!r} (.lst/.txt/.csv) in {selected_list_dir}"
    )


class _CacheUnpickler(pickle.Unpickler):
    """Reads a cache file of either package: the records' classes are this module's
    (the JAX package pickles the same dataclasses under its own module)."""

    def find_class(self, module, name):
        if module.endswith(".data.dataset") and name in ("SourceData", "TargetData"):
            return globals()[name]
        return super().find_class(module, name)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------------- #
# Dataset
# --------------------------------------------------------------------------- #


class TacotronDataset:
    """Zipped source/target corpus with bucketed static-shape batching.

    ``data_root`` layout: ``<id>.source.tfrecord`` and
    ``<id>.target.tfrecord`` files, either in one directory (``source_root
    == target_root``) or split across two roots.
    """

    SOURCE_BUCKET_QUANT = 16   # source lengths rounded up to multiples of this

    def __init__(
        self,
        source_root: str,
        target_root: str,
        hparams,
        utterance_ids: Optional[Sequence[str]] = None,
    ):
        self.hparams = hparams
        self.source_root = source_root
        self.target_root = target_root
        src_ext = "." + hparams.source_file_extension
        available = sorted(
            f[: -len(src_ext)]
            for f in os.listdir(source_root)
            if f.endswith(src_ext)
        )
        if utterance_ids is not None:
            wanted = set(utterance_ids)
            self.ids = [i for i in available if i in wanted]
            missing = wanted - set(self.ids)
            if missing:
                raise FileNotFoundError(
                    f"{len(missing)} selected utterances missing from corpus, "
                    f"e.g. {sorted(missing)[:3]}"
                )
        else:
            self.ids = available
        if not self.ids:
            raise ValueError(f"no utterances found under {source_root}")
        self._cache: Dict[str, Tuple[SourceData, TargetData]] = {}
        # cache_file_name (the tf.data .cache(filename) knob): persist
        # the parsed corpus across processes — one pickle instead of
        # re-parsing thousands of small TFRecord files every run
        if hparams.use_cache and hparams.cache_file_name:
            self._load_file_cache(hparams.cache_file_name)

    def _load_file_cache(self, path: str) -> None:
        if os.path.exists(path):
            with open(path, "rb") as f:
                self._cache = _CacheUnpickler(f).load()

    def save_file_cache(self) -> None:
        """Write the in-memory utterance cache to ``hparams.cache_file_name``."""
        path = self.hparams.cache_file_name
        if not path:
            raise ValueError("hparams.cache_file_name is empty")
        for utt_id in self.ids:          # ensure the cache is complete
            self._cache[utt_id] = self.load_utterance(utt_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self._cache, f)
        os.replace(tmp, path)

    def __len__(self) -> int:
        return len(self.ids)

    def load_utterance(self, utt_id: str) -> Tuple[SourceData, TargetData]:
        if self.hparams.use_cache and utt_id in self._cache:
            return self._cache[utt_id]
        hp = self.hparams
        src = parse_source_tfrecord(
            os.path.join(self.source_root, f"{utt_id}.{hp.source_file_extension}")
        )
        tgt = parse_target_tfrecord(
            os.path.join(self.target_root, f"{utt_id}.{hp.target_file_extension}")
        )
        pair = (src, tgt)
        if self.hparams.use_cache:
            self._cache[utt_id] = pair
        return pair

    # ------------------------------ batching --------------------------- #

    def _target_bucket(self, length: int) -> int:
        hp = self.hparams
        width = max(hp.batch_bucket_width, hp.outputs_per_step)
        width = _round_up(width, hp.outputs_per_step)
        return _round_up(max(length, 1), width)

    def make_batch(self, pairs: List[Tuple[SourceData, TargetData]]) -> Dict[str, np.ndarray]:
        """Pad a list of utterances into one static-shape batch dict."""
        hp = self.hparams
        b = len(pairs)
        s_max = _round_up(max(p[0].source_length for p in pairs), self.SOURCE_BUCKET_QUANT)
        t_max = max(self._target_bucket(p[1].target_length) for p in pairs)

        batch: Dict[str, np.ndarray] = {
            "id": np.array([p[0].id for p in pairs]),
            "source": np.zeros((b, s_max), np.int32),
            "source_lengths": np.zeros((b,), np.int32),
            "target_lengths": np.zeros((b,), np.int32),
            "done": np.zeros((b, t_max), np.float32),
            "speaker_id": np.zeros((b,), np.int32),
        }
        if hp.use_accent_type:
            batch["accent_type"] = np.full(
                (b, s_max), hp.accent_type_unknown, np.int32
            )
        heads = [
            (name, dim)
            for name, dim in (
                ("mel", hp.num_mels),
                ("spec", hp.num_freq),
                ("mgc", hp.num_mgcs),
            )
            if getattr(pairs[0][1], name) is not None
        ]
        for name, dim in heads:
            batch[name] = np.zeros((b, t_max, dim), np.float32)
        if pairs[0][1].lf0 is not None:
            batch["lf0"] = np.zeros((b, t_max), np.int32)

        for i, (src, tgt) in enumerate(pairs):
            s = src.source_length
            batch["source"][i, :s] = src.source[:s]
            batch["source_lengths"][i] = s
            batch["speaker_id"][i] = src.speaker_id
            if hp.use_accent_type and src.accent_type is not None:
                batch["accent_type"][i, :s] = src.accent_type[:s]
            # valid region = true length padded up to a multiple of r; the
            # done target fires at the TRUE last frame (pad region stays 1,
            # teaching the stop token)
            t = _round_up(tgt.target_length, hp.outputs_per_step)
            t = min(t, t_max)
            batch["target_lengths"][i] = t
            batch["done"][i] = make_done_targets(min(tgt.target_length, t), t_max)
            for name, dim in heads:
                arr = getattr(tgt, name)
                batch[name][i, : arr.shape[0]] = arr[:t_max]
            if tgt.lf0 is not None:
                batch["lf0"][i, : tgt.lf0.shape[0]] = tgt.lf0[:t_max]
        return batch

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        repeat: bool = False,
        drop_incomplete: Optional[bool] = None,
        seed: int = 0,
        prefetch: Optional[int] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield length-bucketed padded batches (background-thread prefetched).

        ``prefetch`` defaults to ``hparams.prefetch_buffer_size`` (the
        input-pipeline knob); pass 0 to disable the prefetch thread.
        """
        if prefetch is None:
            prefetch = self.hparams.prefetch_buffer_size
        if drop_incomplete is None:
            drop_incomplete = repeat

        def generate() -> Iterator[Dict[str, np.ndarray]]:
            rng = random.Random(seed)
            epoch = 0
            while True:
                ids = list(self.ids)
                if shuffle:
                    rng.shuffle(ids)
                # group by target-length bucket to minimize padding waste
                buckets: Dict[int, List[Tuple[SourceData, TargetData]]] = {}
                for utt_id in ids:
                    pair = self.load_utterance(utt_id)
                    key = self._target_bucket(pair[1].target_length)
                    bucket = buckets.setdefault(key, [])
                    bucket.append(pair)
                    if len(bucket) == batch_size:
                        yield self.make_batch(bucket)
                        buckets[key] = []
                leftovers = [p for b in buckets.values() for p in b]
                leftovers.sort(key=lambda p: p[1].target_length)
                for i in range(0, len(leftovers), batch_size):
                    chunk = leftovers[i : i + batch_size]
                    if len(chunk) < batch_size:
                        if drop_incomplete:
                            continue
                        chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
                    yield self.make_batch(chunk)
                epoch += 1
                if not repeat:
                    return

        if prefetch <= 0:
            yield from generate()
            return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        _SENTINEL = object()

        def worker():
            try:
                for item in generate():
                    q.put(item)
            finally:
                q.put(_SENTINEL)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            yield item
