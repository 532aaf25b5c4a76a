"""Roofline accounting: how close is a measured rate to the device's peak?

The reference's whole methodology is perf-counter roofline analysis on a
Cortex-A76 (SURVEY.md section 5 "Tracing/profiling": TMA counters, llvm-mca).
Here it is arithmetic: single-stream decode is weight-bandwidth-bound, so
tokens/s roofline = memory bandwidth / bytes touched per token. This module
computes the bytes side from actual QTensor layouts and turns a measured
tokens/s into a fraction-of-roofline figure.
"""

from __future__ import annotations

from typing import Any

# jax device_kind -> (device memory GB/s, dense bf16 TFLOP/s). Source:
# NVIDIA's H100 and H200 data sheets (SXM parts, at their 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 989.0),
    "NVIDIA H200": (4800.0, 989.0),
}


def peaks(device_kind: str) -> tuple[float, float]:
    """(GB/s, bf16 TFLOP/s) of ``device_kind``; a device outside the table
    is an error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device {device_kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def qtensor_bytes(qt: Any) -> int:
    return qt.n_bytes


def model_bytes_per_token(params: dict[str, Any], batch: int = 1) -> dict[str, int]:
    """Device-memory bytes touched per decode step (weights are re-read every token;
    embeddings are gathered, so only ~one row counts)."""
    from kquant.quant.qtensor import QTensor

    weight_bytes = 0
    embed_row_bytes = 0

    def visit(name, node):
        nonlocal weight_bytes, embed_row_bytes
        if isinstance(node, QTensor):
            if node.layout == "rowmajor":
                embed_row_bytes += node.n_bytes // max(1, node.shape[0])
            else:
                weight_bytes += node.n_bytes
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(k, v)
        elif isinstance(node, list):
            for v in node:
                visit(name, v)

    visit("", params)
    return {
        "weight_bytes": weight_bytes,
        "embed_row_bytes": embed_row_bytes * batch,
        "total": weight_bytes + embed_row_bytes * batch,
    }


def kv_bytes_per_token(cfg, seq_len: int, batch: int, quantized: bool) -> int:
    """KV cache bytes read per decode step (attention streams the full
    prefix)."""
    per_tok = cfg.n_kv_heads * cfg.head_dim * (1 if quantized else 2)
    scales = cfg.n_kv_heads * 4 if quantized else 0
    return 2 * cfg.n_layers * batch * seq_len * (per_tok + scales)


def matmul_flops_per_token(params: dict[str, Any]) -> float:
    """Matmul FLOPs per token through every matmul weight (2 * N * K per
    kmajor QTensor). MoE counts every
    expert (the dense-EP path computes them all; for a2a top-k routing this
    overestimates by E/top_k)."""
    import numpy as np

    from kquant.quant.qtensor import QTensor

    flops = 0.0

    def visit(node):
        nonlocal flops
        if isinstance(node, QTensor):
            if node.layout == "kmajor":
                flops += 2.0 * float(np.prod(node.shape))
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(params)
    return flops


def prefill_roofline_report(
    params: dict[str, Any],
    cfg,
    measured_tok_s: float,
    T: int,
    device_kind: str,
    batch: int = 1,
) -> dict[str, float]:
    """Prefill is compute-bound (weights amortize over B*T tokens): the
    ceiling is min(FLOP roofline, weight-stream roofline). The decode report
    (roofline_report) covers the bandwidth-bound regime."""
    hbm_gbs, tflops = peaks(device_kind)
    mm = matmul_flops_per_token(params)
    # causal attention: QK^T + PV, avg context T/2
    attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * (T / 2.0)
    flops_per_tok = mm + attn
    flop_tok_s = tflops * 1e12 / flops_per_tok
    wb = model_bytes_per_token(params, batch)["weight_bytes"]
    mem_tok_s = hbm_gbs * 1e9 / (wb / max(1, batch * T))
    roof = min(flop_tok_s, mem_tok_s)
    return {
        "flops_per_token": float(flops_per_tok),
        "flop_roof_tok_s": float(flop_tok_s),
        "mem_roof_tok_s": float(mem_tok_s),
        "roofline_tok_s": float(roof),
        "bound": "flops" if flop_tok_s <= mem_tok_s else "memory",
        "measured_tok_s": float(measured_tok_s),
        "fraction_of_roofline": float(measured_tok_s / roof),
        "device_kind": device_kind,  # type: ignore[dict-item]
    }


def roofline_report(
    params: dict[str, Any],
    cfg,
    measured_tok_s: float,
    device_kind: str,
    batch: int = 1,
    seq_len: int = 0,
    kv_quantized: bool = False,
) -> dict[str, float]:
    hbm_gbs, _ = peaks(device_kind)
    wb = model_bytes_per_token(params, batch)["total"]
    kb = kv_bytes_per_token(cfg, seq_len, batch, kv_quantized) if seq_len else 0
    bytes_per_step = wb + kb
    roof_steps = hbm_gbs * 1e9 / bytes_per_step
    roof_tok_s = roof_steps * batch
    return {
        "bytes_per_step": float(bytes_per_step),
        "weight_bytes": float(wb),
        "kv_bytes": float(kb),
        "roofline_tok_s": float(roof_tok_s),
        "measured_tok_s": float(measured_tok_s),
        "fraction_of_roofline": float(measured_tok_s / roof_tok_s),
        "device_kind": device_kind,  # type: ignore[dict-item]
    }
