"""Dependency-free TensorBoard event writer.

A copy of `fourdgs_tpu/utils/tb_writer.py` (numpy, PIL and the standard
library only), with `read_tags`, a reader of the tags it wrote. The reference logs through
`torch.utils.tensorboard.SummaryWriter` (reference `train.py:255-263,
276-345`); this hand-encodes the subset of the TF event-file format the
reference uses — scalar, image, and histogram summaries — with the
standard TFRecord framing (length + masked-CRC32C), so that neither
tensorboard nor protobuf is needed. Files land as
`events.out.tfevents.<ts>.<host>` and open in any stock TensorBoard.

Wire format:
  record  = uint64le(len) crc32c_masked(len_bytes) data crc32c_masked(data)
  data    = Event proto: wall_time(1, double) step(2, int64)
            summary(5, Summary) | file_version(3, string)
  Summary = repeated Value(1): tag(1, string) simple_value(2, float)
            image(4, Image) histo(7, HistogramProto)
  Image   = height(1) width(2) colorspace(3) encoded_image_string(4)
  Histo   = min(1) max(2) num(3) sum(4) sum_squares(5)
            bucket_limit(7, packed double) bucket(8, packed double)
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time

import numpy as np

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78                    # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & (2 ** 64 - 1))


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_packed_doubles(field: int, vals) -> bytes:
    return _f_bytes(field, b"".join(struct.pack("<d", float(v))
                                    for v in vals))


# --------------------------------------------------------------- writer
class TBWriter:
    """SummaryWriter-equivalent for scalars/images/histograms."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(logdir, fname), "ab")
        self._record(_f_double(1, time.time())
                     + _f_bytes(3, b"brain.Event:2"))

    def _record(self, event: bytes) -> None:
        ln = struct.pack("<Q", len(event))
        self._f.write(ln + struct.pack("<I", _masked_crc(ln)) + event
                      + struct.pack("<I", _masked_crc(event)))

    def _event(self, step: int, value: bytes) -> None:
        self._record(_f_double(1, time.time()) + _f_varint(2, int(step))
                     + _f_bytes(5, _f_bytes(1, value)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._event(step, _f_bytes(1, tag.encode())
                    + _f_float(2, float(value)))

    def add_image(self, tag: str, img, step: int) -> None:
        """img: (H, W, 3) float [0,1] or uint8."""
        from PIL import Image as PILImage

        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        buf = io.BytesIO()
        PILImage.fromarray(arr).save(buf, format="PNG")
        image = (_f_varint(1, arr.shape[0]) + _f_varint(2, arr.shape[1])
                 + _f_varint(3, 3) + _f_bytes(4, buf.getvalue()))
        self._event(step, _f_bytes(1, tag.encode()) + _f_bytes(4, image))

    def add_histogram(self, tag: str, values, step: int,
                      bins: int = 30) -> None:
        v = np.asarray(values, np.float64).reshape(-1)
        if v.size == 0:
            return
        counts, edges = np.histogram(v, bins=bins)
        histo = (_f_double(1, float(v.min())) + _f_double(2, float(v.max()))
                 + _f_double(3, float(v.size)) + _f_double(4, float(v.sum()))
                 + _f_double(5, float((v * v).sum()))
                 + _f_packed_doubles(7, edges[1:])
                 + _f_packed_doubles(8, counts))
        self._event(step, _f_bytes(1, tag.encode()) + _f_bytes(7, histo))

    def close(self) -> None:
        self._f.close()


# --------------------------------------------------------------- reader
def _fields(buf: bytes):
    """A protobuf message -> [(field, value)]: varints as ints, 64- and
    32-bit fields as raw bytes, length-delimited fields as bytes."""
    def varint(i):
        v = shift = 0
        while True:
            b = buf[i]
            v |= (b & 0x7F) << shift
            shift, i = shift + 7, i + 1
            if not b & 0x80:
                return v, i

    fields, i = [], 0
    while i < len(buf):
        key, i = varint(i)
        wire = key & 7
        if wire == 0:
            v, i = varint(i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            v, i = buf[i: i + n], i + n
        else:
            n, i = varint(i)
            v, i = buf[i: i + n], i + n
        fields.append((key >> 3, v))
    return fields


def read_tags(path: str) -> dict:
    """{tag: [steps]} of the summaries in an event file written by
    TBWriter, in the order written."""
    tags = {}
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i + 12 <= len(data):
        n = int.from_bytes(data[i: i + 8], "little")
        event = {}
        for field, v in _fields(data[i + 12: i + 12 + n]):
            event.setdefault(field, []).append(v)
        i += 16 + n
        for summary in event.get(5, []):
            for field, value in _fields(summary):
                if field == 1:
                    tag = dict(_fields(value))[1].decode()
                    tags.setdefault(tag, []).append(event[2][0])
    return tags
