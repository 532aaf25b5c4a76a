"""GGUF container I/O: mmap reader (zero-copy views) and v3 writer."""

from kquant.gguf.constants import (  # noqa: F401
    GGMLType,
    GGUFValueType,
    QK_K,
    block_size,
    is_quantized,
    row_size,
    type_size,
)
from kquant.gguf.reader import GGUFReader, TensorInfo  # noqa: F401
from kquant.gguf.writer import GGUFWriter  # noqa: F401
