"""TFRecord container + tf.train.Example wire-format codec, dependency-free.

The port's own copy of the JAX package's ``utils/tfrecord.py``: per-utterance
record write, feature encode/decode helpers, parse functions, written from the
public TFRecord/protobuf wire specifications in pure Python, so the data layer
imports no TensorFlow and corpora written by either package load in the other.

TFRecord framing (per record):
  uint64 length · uint32 masked_crc32c(length) · bytes data ·
  uint32 masked_crc32c(data)
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple, Union

import numpy as np

# --------------------------------------------------------------------------- #
# CRC32C (Castagnoli), table-driven; masking per the TFRecord spec
# --------------------------------------------------------------------------- #

_CRC_TABLE = []


def _build_crc_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_crc_table()


def _crc_bytes(crc: int, data: bytes) -> int:
    """The CRC register after ``data``, from ``crc``, one byte at a time."""
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


# A record of a mel spectrogram is hundreds of kilobytes, which the byte loop takes
# tens of milliseconds over. Longer data is cut into chunks of _CHUNK bytes whose
# registers numpy advances side by side from 0; the register update is linear over
# GF(2), so the register after chunk k is that of chunk k-1 pushed through _CHUNK
# zero bytes (_shift_tables), xor chunk k's own.
_CHUNK = 512


@functools.lru_cache(maxsize=1)
def _shift_tables() -> np.ndarray:
    """(4, 256) tables: the register ``v`` after _CHUNK zero bytes is the xor of
    ``tables[j][(v >> 8 * j) & 0xFF]`` over j."""
    table = np.asarray(_CRC_TABLE, np.uint32)
    basis = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    for _ in range(_CHUNK):
        basis = table[basis & 0xFF] ^ (basis >> 8)
    tables = np.zeros((4, 256), np.uint32)
    for j in range(4):
        for bit in range(8):
            has = (np.arange(256) >> bit) & 1 == 1
            tables[j, has] ^= basis[8 * j + bit]
    return tables


def crc32c(data: bytes) -> int:
    chunks = len(data) // _CHUNK
    if chunks < 8:
        return _crc_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    table = np.asarray(_CRC_TABLE, np.uint32)
    lanes = np.frombuffer(data, np.uint8, chunks * _CHUNK).reshape(chunks, _CHUNK)
    raw = np.zeros(chunks, np.uint32)
    for j in range(_CHUNK):
        raw = table[(raw ^ lanes[:, j]) & 0xFF] ^ (raw >> 8)
    shift = _shift_tables().tolist()
    crc = 0xFFFFFFFF
    for r in raw.tolist():
        crc = (shift[0][crc & 0xFF] ^ shift[1][(crc >> 8) & 0xFF]
               ^ shift[2][(crc >> 16) & 0xFF] ^ shift[3][crc >> 24] ^ r)
    return _crc_bytes(crc, data[chunks * _CHUNK:]) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Record-level I/O
# --------------------------------------------------------------------------- #


def write_records(path: str, records: Iterable[bytes]) -> None:
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise IOError(f"{path}: corrupt length crc")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise IOError(f"{path}: corrupt data crc")
            yield data


# --------------------------------------------------------------------------- #
# Minimal protobuf wire codec for tf.train.Example
# --------------------------------------------------------------------------- #

FeatureValue = Union[bytes, str, Sequence[int], Sequence[float], np.ndarray]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_feature(value: FeatureValue) -> bytes:
    """Encode one Feature message (oneof bytes/float/int64 list)."""
    if isinstance(value, str):
        value = value.encode("utf-8")
    if isinstance(value, bytes):
        inner = _len_delim(1, value)              # BytesList.value
        return _len_delim(1, inner)               # Feature.bytes_list
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        data = arr.astype("<f4").tobytes()
        inner = _tag(1, 2) + _varint(len(data)) + data   # packed FloatList.value
        return _len_delim(2, inner)               # Feature.float_list
    if arr.dtype.kind in ("i", "u"):
        payload = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in arr.reshape(-1))
        inner = _tag(1, 2) + _varint(len(payload)) + payload  # packed Int64List
        return _len_delim(3, inner)               # Feature.int64_list
    raise TypeError(f"unsupported feature value type: {arr.dtype}")


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize a tf.train.Example with the given feature map."""
    entries = b""
    for key in features:  # insertion order; TF accepts any map-entry order
        entry = _len_delim(1, key.encode("utf-8")) + _len_delim(
            2, _encode_feature(features[key])
        )
        entries += _len_delim(1, entry)           # Features.feature map entry
    return _len_delim(1, entries)                 # Example.features


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a message buffer."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + n]
            pos += n
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, _varint(v)
        else:
            start = pos
            pos = _skip_field(buf, pos - 0, wire)
            yield field, wire, buf[start:pos]


def _decode_feature(buf: bytes):
    for field, wire, payload in _iter_fields(buf):
        if field == 1:  # bytes_list
            values: List[bytes] = []
            for f2, _, p2 in _iter_fields(payload):
                if f2 == 1:
                    values.append(p2)
            return values[0] if len(values) == 1 else values
        if field == 2:  # float_list
            floats: List[float] = []
            for f2, w2, p2 in _iter_fields(payload):
                if f2 == 1:
                    if w2 == 2:  # packed
                        floats.extend(np.frombuffer(p2, dtype="<f4").tolist())
                    else:        # unpacked fixed32
                        floats.append(struct.unpack("<f", p2)[0])
            return np.asarray(floats, np.float32)
        if field == 3:  # int64_list
            ints: List[int] = []
            for f2, w2, p2 in _iter_fields(payload):
                if f2 == 1:
                    if w2 == 2:  # packed varints
                        pos = 0
                        while pos < len(p2):
                            v, pos = _read_varint(p2, pos)
                            ints.append(v - (1 << 64) if v >= (1 << 63) else v)
                    else:
                        v, _ = _read_varint(p2, 0)
                        ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            return np.asarray(ints, np.int64)
    return None


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized tf.train.Example into {name: value}."""
    out: Dict[str, FeatureValue] = {}
    for field, _, payload in _iter_fields(data):
        if field != 1:
            continue
        for f2, _, entry in _iter_fields(payload):
            if f2 != 1:
                continue
            key = None
            value = None
            for f3, _, p3 in _iter_fields(entry):
                if f3 == 1:
                    key = p3.decode("utf-8")
                elif f3 == 2:
                    value = _decode_feature(p3)
            if key is not None:
                out[key] = value
    return out


# --------------------------------------------------------------------------- #
# Convenience: single-example-per-file (the per-utterance layout)
# --------------------------------------------------------------------------- #


def write_example_file(path: str, features: Dict[str, FeatureValue]) -> None:
    write_records(path, [encode_example(features)])


def read_example_file(path: str) -> Dict[str, FeatureValue]:
    for record in read_records(path):
        return decode_example(record)
    raise IOError(f"{path}: empty tfrecord file")
