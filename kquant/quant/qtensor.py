"""QTensor: a quantized tensor as a JAX pytree of packed device arrays.

This is the on-device analog of the reference's quantized ggml tensors (whose
``data`` pointers alias the GGUF mmap, SURVEY.md section 3.2): packed bits stay
packed in device memory; kernels dequantize tiles in registers.

Two layouts:

- ``kmajor``  — for matmul weights W with logical shape (N, K): arrays are
  stored K-major ([K/2, N] packed nibbles etc.) so the contraction dimension
  is the row axis of weight tiles and output columns are contiguous.
  Nibble fold: byte (k, n) holds element k (low nibble) and element k + K/2
  (high nibble), so unpack is `concat([b & 15, b >> 4], axis=0)` — pure
  masks plus a concat along K, no shuffles within a row.
- ``rowmajor`` — for embedding tables (gather along N): arrays keep rows
  intact ([N, K/2] fold along K within each row).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QTensor:
    """Packed quantized tensor.

    kind: 'q4_k' | 'q5_k' | 'q6_k' | 'q8_0' | 'q3_k' | 'q2_k' | 'dense'
    layout: 'kmajor' | 'rowmajor' | 'dense'
    shape: logical float shape, numpy row-major (e.g. (N, K) for a weight)
    arrays: packed fields, e.g. {'qs': u8[K/2, N], 'scales': f32[K/32, N], ...}
    """

    kind: str
    layout: str
    shape: tuple[int, ...]
    arrays: dict[str, Any]
    # TP orientation tag ('col' | 'row' | None), set by parallel.sharding
    # when the tensor is sharded over a mesh: under an active
    # parallel.tp_shard_constraints context, ops.qmatmul pins the dequanted
    # weight to this orientation so XLA's SPMD partitioner cannot decide to
    # reshard packed weights inside the layer loop (tools_scale_ready found
    # it doing exactly that — per-layer multi-MB weight all_to_alls).
    tp: str | None = None
    # bit-fold block count along the packed-K axis. fold=1 is the global
    # fold documented above (byte k pairs codes k and k + K/2). A row(K)-
    # parallel TP shard of a fold=1 tensor can NEVER produce a contiguous
    # K-block of codes locally (its bytes pair k with k + K/2, which lives
    # on another shard) — XLA implements the unpack as a per-layer
    # all_to_all of the packed codes. quant.repack.refold_kmajor re-packs
    # with fold = n_shards so each shard's unpack is fully local; the jnp
    # unpacker handles any fold, the Pallas kernels require fold == 1
    # (ops.qmatmul falls back to the XLA path otherwise).
    fold: int = 1

    def tree_flatten(self):
        keys = sorted(self.arrays)
        return ([self.arrays[k] for k in keys],
                (self.kind, self.layout, self.shape, tuple(keys), self.tp,
                 self.fold))

    @classmethod
    def tree_unflatten(cls, aux, children):
        kind, layout, shape, keys = aux[:4]
        tp = aux[4] if len(aux) > 4 else None
        fold = aux[5] if len(aux) > 5 else 1
        return cls(kind, layout, shape, dict(zip(keys, children)), tp, fold)

    @property
    def n_bytes(self) -> int:
        return sum(v.size * v.dtype.itemsize for v in jax.tree.leaves(self.arrays))

    @property
    def bits_per_element(self) -> float:
        import numpy as np

        return self.n_bytes * 8.0 / float(np.prod(self.shape))

    def astype_scales(self, dtype) -> "QTensor":
        """Cast scale/min side-arrays (not packed codes) to ``dtype``."""
        arrs = {
            k: (v.astype(dtype) if v.dtype in (jnp.float32, jnp.bfloat16, jnp.float16) else v)
            for k, v in self.arrays.items()
        }
        return QTensor(self.kind, self.layout, self.shape, arrs, self.tp,
                       self.fold)
