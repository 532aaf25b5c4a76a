#!/usr/bin/env python
"""Time the fused dequant-matmul kernel against the plain XLA path on the GPU.

For every projection of the TinyLlama-1.1B and Llama-3-8B Q4_K_M presets
(random packed weights in the loader's bf16-pair layout) and every row count,
prints one JSON line with both device times (summed kernel durations from a
profiler trace), the packed bytes read and the kernel's error against a
float32 reference.

    python tools_qmm_bench.py [--rows 1,8,32,512] [--presets tiny,8b]
                              [--sweep] [--out qmm_bench.jsonl]

--sweep also times the kernel over block widths and split-K at each shape
with at most 32 rows.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,8,32,512")
    ap.add_argument("--presets", default="tiny,8b")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from kquant.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from kquant.models.fixtures import (llama3_8b_config, projection_shapes,
                                        random_qtensor, tinyllama_1b_config)
    from kquant.ops import qmm_triton
    from kquant.ops.qmatmul import qmatmul
    from kquant.quant.jnp_codecs import dequant_kmajor
    from kquant.utils.profiling import device_seconds

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"needs a GPU, found {jax.devices()}")
    cfgs = {"tiny": tinyllama_1b_config(), "8b": llama3_8b_config()}
    rows_list = [int(r) for r in args.rows.split(",")]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for preset in args.presets.split(","):
        for name, kind, K, N in projection_shapes(cfgs[preset]):
            qt = random_qtensor(kind, N, K, "bf16", seed=K + N)
            nbytes = qt.n_bytes
            w = jax.jit(lambda q: dequant_kmajor(q, jnp.float32))(qt)
            for R in rows_list:
                x = jax.random.normal(jax.random.PRNGKey(R), (R, K),
                                      jnp.bfloat16)
                xla = jax.jit(lambda x, q: qmatmul(x, q, impl="xla",
                                                   out_dtype=jnp.float32))
                ker = jax.jit(lambda x, q: qmm_triton.qmm_triton(
                    x, q, out_dtype=jnp.float32))
                with jax.default_matmul_precision("highest"):
                    ref = jax.jit(jnp.matmul)(x.astype(jnp.float32), w)
                y = ker(x, qt)
                err = float(jnp.max(jnp.abs(y - ref)) / jnp.max(jnp.abs(ref)))
                rec = {"preset": preset, "proj": name, "kind": kind, "K": K,
                       "N": N, "rows": R, "plan": qmm_triton.plan(kind, K, N, R),
                       "packed_mb": nbytes / 1e6, "rel_err": err,
                       "xla_us": device_seconds(xla, x, qt, reps=args.reps) * 1e6,
                       "kernel_us": device_seconds(ker, x, qt, reps=args.reps) * 1e6}
                rec["kernel_gbs"] = nbytes / rec["kernel_us"] / 1e3
                rec["xla_gbs"] = nbytes / rec["xla_us"] / 1e3
                emit(rec)
                if not args.sweep or R > 32:
                    continue
                p_split = rec["plan"][1]
                splits = sorted({1, max(1, p_split // 2), p_split, 2 * p_split})
                for bn in (32, 64, 128, 256):
                    for split in splits:
                        f = jax.jit(lambda x, q, bn=bn, s=split:
                                    qmm_triton.qmm_triton(
                                        x, q, out_dtype=jnp.float32,
                                        bn=bn, split=s))
                        try:
                            us = device_seconds(f, x, qt, reps=args.reps) * 1e6
                        except (ValueError, jax.errors.JaxRuntimeError) as e:
                            emit({"sweep": name, "rows": R, "bn": bn,
                                  "split": split, "error": str(e)[:200]})
                            continue
                        emit({"sweep": name, "preset": preset, "rows": R,
                              "bn": bn, "split": split, "us": us,
                              "gbs": nbytes / us / 1e3})


if __name__ == "__main__":
    main()
