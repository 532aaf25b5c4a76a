"""GGUF v3 writer.

The reference consumes GGUF produced elsewhere; we additionally need to
*produce* GGUF (synthesizing exact-architecture fixture models for tests and
benchmarks, and exporting converted checkpoints), so the container writer is
part of the framework's model-I/O layer (SURVEY.md section 2.1, GGUF reader
row).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

from kquant.gguf.constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    row_size,
)

_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


_NP_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


class GGUFWriter:
    """Accumulates metadata + tensors, then writes a valid GGUF v3 file."""

    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, value, vtype or _infer_vtype(value)))

    def add_tensor(
        self,
        name: str,
        array: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw: np.ndarray | None = None,
    ) -> None:
        """Add a tensor; quantizes ``array`` to ``ggml_type`` unless ``raw``
        pre-encoded bytes are given. ``array.shape`` is numpy row-major order
        (stored reversed on disk, ggml ne[] order)."""
        if raw is None:
            # local import: quant depends on gguf.constants (avoid module cycle)
            from kquant.quant import quantize

            ggml_type = ggml_type or GGMLType.F32
            raw = quantize(np.asarray(array, np.float32), ggml_type)
        else:
            assert ggml_type is not None
            expect = row_size(ggml_type, int(np.prod(array.shape)))
            assert raw.size == expect, (name, raw.size, expect)
        self._tensors.append((name, tuple(array.shape), ggml_type, np.asarray(raw, np.uint8)))

    # -- serialization ---------------------------------------------------------
    def _pack_string(self, s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _pack_value(self, v: Any, vtype: GGUFValueType) -> bytes:
        if vtype == GGUFValueType.STRING:
            return self._pack_string(v)
        if vtype == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray):
                item_t = _NP_VTYPE[v.dtype]
                out = struct.pack("<IQ", item_t, v.size)
                fmt = _SCALAR_PACK[item_t].lstrip("<")
                return out + v.astype(f"<{fmt}").tobytes()
            if len(v) == 0:
                return struct.pack("<IQ", GGUFValueType.INT32, 0)
            item_t = _infer_vtype(v[0])
            # promote mixed int arrays conservatively
            if item_t in (GGUFValueType.UINT32, GGUFValueType.UINT64) and any(
                isinstance(x, int) and x < 0 for x in v
            ):
                item_t = GGUFValueType.INT64
            out = struct.pack("<IQ", item_t, len(v))
            for x in v:
                out += self._pack_value(x, item_t)
            return out
        return struct.pack(_SCALAR_PACK[vtype], v)

    def write(self) -> Path:
        header = struct.pack("<IIqq", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kv))
        body = bytearray(header)
        for key, value, vtype in self._kv:
            body += self._pack_string(key)
            body += struct.pack("<I", vtype)
            body += self._pack_value(value, vtype)

        # tensor directory with alignment-padded running offsets
        offset = 0
        datas = []
        for name, shape, ggml_type, raw in self._tensors:
            body += self._pack_string(name)
            ne = tuple(reversed(shape))
            body += struct.pack("<I", len(ne))
            for d in ne:
                body += struct.pack("<Q", d)
            body += struct.pack("<IQ", ggml_type, offset)
            datas.append((offset, raw))
            offset += raw.size + (-raw.size % self.alignment)

        body += b"\x00" * (-len(body) % self.alignment)
        data_start = len(body)
        body += b"\x00" * offset
        for off, raw in datas:
            body[data_start + off : data_start + off + raw.size] = raw.tobytes()

        self.path.write_bytes(bytes(body))
        return self.path
