"""GSPMD sharding rules for packed QTensors (TP/DP; EP via expert sharding).

Megatron-style tensor parallelism, adapted to packed layouts: column-parallel
projections shard the output dim N (the lane axis of every kmajor array);
row-parallel projections shard the contraction dim K — and because every
kmajor side array's leading axis is K-derived (K/2 nibbles, K/8 qh bits,
K/g scales), one PartitionSpec per orientation covers all packed fields, and
256-element superblocks never straddle shards as long as K/(2*n_model) stays
a multiple of the pack fold (guaranteed: K multiple of 256, n_model a power
of two). XLA inserts the all-reduce after row-parallel matmuls.
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kquant.quant.qtensor import QTensor

# -- TP weight-constraint context -------------------------------------------
# Why this exists (tools_scale_ready.py, r5): lowering the 70B-geometry
# decode step TP-sharded showed XLA's SPMD partitioner CHOOSING to reshard
# the packed q4 weight arrays (multi-MB all_to_alls) inside the per-layer
# loop rather than honoring the Megatron col/row placement the loader set.
# Under this context, ops.qmatmul pins each dequanted weight to its
# QTensor.tp orientation with with_sharding_constraint, which removes those
# reshards (activations remain free for the partitioner to place).
_TP_CTX: "tuple | None" = None


class tp_shard_constraints:
    """Context manager: ``with tp_shard_constraints(mesh): jit(fwd).lower``
    (or run) — qmatmul pins dequanted weights to their TP orientation."""

    def __init__(self, mesh: Mesh, axis: str = "model"):
        self.ctx = (mesh, axis)

    def __enter__(self):
        global _TP_CTX
        self._prev, _TP_CTX = _TP_CTX, self.ctx
        return self

    def __exit__(self, *exc):
        global _TP_CTX
        _TP_CTX = self._prev
        return False


def current_tp_ctx():
    return _TP_CTX


# tensor-name suffix -> TP orientation
_COLUMN_PARALLEL = ("attn_q.weight", "attn_k.weight", "attn_v.weight",
                    "attn_qk.weight", "ffn_gateup.weight",
                    "ffn_gate.weight", "ffn_up.weight", "output.weight",
                    "ffn_gate_exps.weight", "ffn_up_exps.weight")
_ROW_PARALLEL = ("attn_output.weight", "ffn_down.weight", "ffn_down_exps.weight")


def _orientation(name: str) -> str:
    if any(name.endswith(s) or s in name for s in _ROW_PARALLEL):
        return "row"
    if any(name.endswith(s) or s in name for s in _COLUMN_PARALLEL):
        return "col"
    return "replicated"


def _divisible(qt: QTensor, axis: int, n: int) -> bool:
    return all(v.shape[axis] % n == 0 for v in qt.arrays.values() if v.ndim == 2)


def shard_qtensor(qt: QTensor, mesh: Mesh, orientation: str) -> QTensor:
    """device_put a QTensor with TP (+EP for stacked experts) sharding.

    kmajor arrays are [K-ish, N]; stacked expert arrays are [E, K-ish, N]
    and additionally shard their leading axis over 'expert'."""
    n_model = mesh.shape["model"]
    n_expert = mesh.shape["expert"]

    def spec_for(v) -> P:
        tp: tuple = (None, None)
        kax, nax = v.ndim - 2, v.ndim - 1
        if qt.layout == "kmajor" and n_model > 1 and v.ndim >= 2:
            if orientation == "col" and v.shape[nax] % n_model == 0:
                tp = (None, "model")
            elif orientation == "row" and v.shape[kax] % n_model == 0:
                tp = ("model", None)
        if v.ndim == 3:
            e = "expert" if (n_expert > 1 and v.shape[0] % n_expert == 0) else None
            return P(e, *tp)
        if v.ndim == 2:
            return P(*tp)
        return P()

    if orientation == "row" and n_model > 1:
        # row(K)-parallel + global bit fold = per-layer all_to_all of the
        # packed codes (the partner nibble lives on another shard); re-pack
        # with a shard-local fold so each shard unpacks its own bytes
        from kquant.quant.repack import refold_kmajor

        qt = refold_kmajor(qt, n_model)
    arrays = {
        k: jax.device_put(v, NamedSharding(mesh, spec_for(v)))
        for k, v in qt.arrays.items()
    }
    tp = orientation if (n_model > 1 and orientation in ("col", "row")) else None
    return QTensor(qt.kind, qt.layout, qt.shape, arrays, tp, qt.fold)


def make_param_put(mesh: Mesh, moe_impl: str = "ep"):
    """A ``put(name, qtensor)`` for runtime.loader.load_model that applies the
    TP rules above (embeddings and norms replicated).

    moe_impl: expert-parallel strategy when mesh has an 'expert' axis —
    'ep' (dense sharded einsum) or 'a2a' (ragged all_to_all dispatch,
    models.moe_a2a; requires passing mesh= to the engine/forward)."""

    def put(name: str, qt: QTensor) -> QTensor:
        return shard_qtensor(qt, mesh, _orientation(name))

    put.tp_size = mesh.shape["model"]  # loader disables QK/gate-up fusion when >1
    put.ep_size = mesh.shape["expert"]  # loader switches MoE to the EP path
    put.moe_impl = moe_impl
    return put


# params-pytree key -> TP orientation (models.fixtures.random_qparams naming;
# the GGUF loader path goes through _orientation on tensor names instead)
_KEY_ORIENT = {
    "wq": "col", "wk": "col", "wv": "col", "wqk": "col", "wqkv": "col",
    "w_gate": "col", "w_up": "col", "w_gateup": "col", "gate_inp": "replicated",
    "wo": "row", "w_down": "row", "output": "col",
}


def shard_random_params(params: dict[str, Any], mesh: Mesh) -> dict[str, Any]:
    """Apply the TP/EP sharding rules to a fixture params pytree
    (models.fixtures.random_qparams) — same specs the loader's put applies
    to a real GGUF load, keyed on pytree keys instead of tensor names.
    Works on materialized arrays AND on ShapeDtypeStruct avals (the
    AOT-lowering path attaches shardings without materializing weights)."""
    import jax.numpy as jnp

    def put_qt(qt: QTensor, orient: str) -> QTensor:
        n_model = mesh.shape.get("model", 1)
        fold = qt.fold
        if orient == "row" and n_model > 1 and qt.layout == "kmajor":
            if any(isinstance(v, jax.ShapeDtypeStruct)
                   for v in qt.arrays.values()):
                # aval path (AOT lowering): shapes are fold-invariant — tag
                # the fold so the unpacker lowers the block-local pattern
                if (qt.kind not in ("q8", "q6w", "dense")
                        and qt.shape[-1] % (n_model * 256) == 0):
                    fold = n_model
            else:
                from kquant.quant.repack import refold_kmajor

                qt = refold_kmajor(qt, n_model)
                fold = qt.fold

        def one(v):
            spec = _aval_spec(v, qt, orient, mesh)
            sh = NamedSharding(mesh, spec)
            if isinstance(v, jax.ShapeDtypeStruct):
                return jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=sh)
            return jax.device_put(jnp.asarray(v), sh)

        tp = (orient if (mesh.shape.get("model", 1) > 1
                         and orient in ("col", "row")) else None)
        return QTensor(qt.kind, qt.layout, qt.shape,
                       {k: one(v) for k, v in qt.arrays.items()}, tp, fold)

    def walk(d, orient_of):
        out = {}
        for k, v in d.items():
            if isinstance(v, QTensor):
                out[k] = put_qt(v, orient_of(k))
            elif isinstance(v, dict):
                out[k] = walk(v, orient_of)
            elif isinstance(v, list):
                out[k] = [walk(e, orient_of) for e in v]
            else:
                out[k] = v
        return out

    return walk(params, lambda k: _KEY_ORIENT.get(k, "replicated"))


def _aval_spec(v, qt: QTensor, orientation: str, mesh: Mesh) -> P:
    """The spec shard_qtensor.spec_for computes, for arrays or avals."""
    n_model = mesh.shape.get("model", 1)
    n_expert = mesh.shape.get("expert", 1)
    tp: tuple = (None, None)
    kax, nax = v.ndim - 2, v.ndim - 1
    if qt.layout == "kmajor" and n_model > 1 and v.ndim >= 2:
        if orientation == "col" and v.shape[nax] % n_model == 0:
            tp = (None, "model")
        elif orientation == "row" and v.shape[kax] % n_model == 0:
            tp = ("model", None)
    if v.ndim == 3:
        e = "expert" if (n_expert > 1 and v.shape[0] % n_expert == 0) else None
        return P(e, *tp)
    if v.ndim == 2:
        return P(*tp)
    return P()


def shard_cache(cache: Any, mesh: Mesh) -> Any:
    """Shard a KVCache: batch over 'data', kv heads over 'model'.
    ISWACache shards its full and ring sub-caches the same way."""
    from kquant.runtime.kv_cache import ISWACache

    if isinstance(cache, ISWACache):
        import dataclasses

        return dataclasses.replace(
            cache,
            full=None if cache.full is None else shard_cache(cache.full, mesh),
            swa=None if cache.swa is None else shard_cache(cache.swa, mesh),
        )
    n_model = mesh.shape["model"]
    n_data = mesh.shape["data"]

    def put(x, with_head_axis: bool):
        if x is None:
            return None
        spec = [None] * x.ndim  # [L, B, Hkv, S(, D)]
        if n_data > 1 and x.shape[1] % n_data == 0:
            spec[1] = "data"
        h_ax = 2
        if with_head_axis and n_model > 1 and x.shape[h_ax] % n_model == 0:
            spec[h_ax] = "model"
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    from kquant.runtime.kv_cache import KVCache

    return KVCache(
        k=put(cache.k, True),
        v=put(cache.v, True),
        k_scale=put(cache.k_scale, True),
        v_scale=put(cache.v_scale, True),
    )
