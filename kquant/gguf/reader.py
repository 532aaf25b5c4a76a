"""GGUF v2/v3 container reader with zero-copy mmap tensor views.

JAX-side replacement for the reference's model-I/O layer (SURVEY.md
section 3.2): ``gguf_reader::read`` + ``llama_mmap`` (evidence
``artifacts/perf/out.folded:2-3,17-18``).  Like the reference, weights are
never copied on parse: each tensor is a NumPy ``uint8`` view into one
``mmap(2)`` of the file; dequantization/repacking happens later, at
device-put time.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from kquant.gguf.constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    row_size,
)

_SCALAR_FMT = {
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


@dataclass(frozen=True)
class TensorInfo:
    """One entry of the GGUF tensor directory.

    ``shape`` is the row-major NumPy shape, i.e. the *reverse* of the on-disk
    ggml ``ne[]`` order (ggml stores the contiguous dimension first).
    """

    name: str
    shape: tuple[int, ...]
    ggml_type: GGMLType
    offset: int  # relative to the aligned data section

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def n_bytes(self) -> int:
        return row_size(self.ggml_type, self.n_elements)


class GGUFReader:
    """Parses metadata + tensor directory; exposes mmap'd tensor bytes."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._parse()

    # -- low-level cursor reads ------------------------------------------------
    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += size
        return vals[0] if len(vals) == 1 else vals

    def _read_string(self) -> str:
        n = self._read("<Q")
        s = bytes(self._mm[self._pos : self._pos + n])
        self._pos += n
        return s.decode("utf-8", errors="replace")

    def _read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self._read_string()
        if vtype == GGUFValueType.ARRAY:
            item_type = GGUFValueType(self._read("<I"))
            n = self._read("<Q")
            if item_type in _SCALAR_FMT and item_type != GGUFValueType.BOOL:
                fmt = _SCALAR_FMT[item_type]
                itemsize = struct.calcsize(fmt)
                arr = np.frombuffer(
                    self._mm, dtype=fmt, count=n, offset=self._pos
                ).copy()
                self._pos += n * itemsize
                return arr
            return [self._read_value(item_type) for _ in range(n)]
        return self._read(_SCALAR_FMT[vtype])

    # -- container parse -------------------------------------------------------
    def _parse(self) -> None:
        magic = self._read("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        self.version = self._read("<I")
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = self._read("<q")
        n_kv = self._read("<q")
        for _ in range(n_kv):
            key = self._read_string()
            vtype = GGUFValueType(self._read("<I"))
            self.metadata[key] = self._read_value(vtype)

        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))

        infos = []
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read("<I")
            ne = [self._read("<Q") for _ in range(n_dims)]
            ggml_type = GGMLType(self._read("<I"))
            offset = self._read("<Q")
            infos.append(TensorInfo(name, tuple(reversed(ne)), ggml_type, offset))

        pad = -self._pos % self.alignment
        self.data_offset = self._pos + pad
        for ti in infos:
            self.tensors[ti.name] = ti

    # -- tensor access ---------------------------------------------------------
    def tensor_bytes(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's raw (possibly quantized) bytes."""
        ti = self.tensors[name]
        start = self.data_offset + ti.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=ti.n_bytes, offset=start)

    def tensor_float(self, name: str) -> np.ndarray:
        """Dequantized float32 copy of a tensor (host-side reference path)."""
        from kquant.quant import dequantize

        ti = self.tensors[name]
        return dequantize(self.tensor_bytes(name), ti.ggml_type, ti.shape)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views are still alive; the map is released when
            # the last view is garbage-collected (same lifetime rule as the
            # reference's mmap-backed tensors)
            pass
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
