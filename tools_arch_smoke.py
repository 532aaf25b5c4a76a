#!/usr/bin/env python
"""Arch-family smoke on the GPU: greedy tokens must MATCH between
impl='auto' (the backend's kernels) and impl='xla', at dims large enough
that the fused dequant-matmul kernel takes every projection.

Covers what interpret-mode tests cannot: each family's projections through
the compiled kernel — qwen2 attention biases, phi3 pre-fused QKV, gemma2
softcaps/post-norms, llama NORM-rope canonicalization, mamba.

  python tools_arch_smoke.py [--arch llama qwen2 phi3 gemma2]
"""
import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax

from kquant.utils.cache import enable_compile_cache


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["llama", "qwen2", "phi3", "gemma2", "mamba"])
    ap.add_argument("--tokens", type=int, default=12)
    args = ap.parse_args()
    enable_compile_cache()

    from kquant.models.fixtures import (
        tiny_config, tiny_mamba_config, write_fixture_gguf)
    from kquant.runtime import InferenceEngine, load_model

    log(f"devices: {jax.devices()}")
    failures = []
    with tempfile.TemporaryDirectory() as td:
        for arch in args.arch:
            if arch == "mamba":
                cfg = tiny_mamba_config(n_layers=2, dim=512, vocab_size=512)
            else:
                cfg = tiny_config(
                    arch=arch, n_layers=2, dim=512, n_heads=8, n_kv_heads=2,
                    ffn_dim=768, vocab_size=512, max_seq_len=256,
                    sliding_window=64 if arch == "gemma2" else 0,
                )
            path = f"{td}/{arch}.gguf"
            write_fixture_gguf(path, cfg, seed=11, quant="q4_k_m", scale=0.08)
            outs = {}
            for impl in ("auto", "xla"):
                c2, params, r = load_model(path, scale_dtype="bf16")
                eng = InferenceEngine(c2, params, max_batch=1, max_seq=128,
                                      impl=impl)
                outs[impl] = eng.generate([[3, 5, 7, 11, 13]],
                                          max_new_tokens=args.tokens)[0]
                r.close()
            ok = outs["auto"] == outs["xla"]
            log(f"{arch:8s}: auto==xla -> {ok}  ({outs['auto'][:6]}...)")
            if not ok:
                log(f"  auto: {outs['auto']}\n  xla : {outs['xla']}")
                failures.append(arch)
    if failures:
        log(f"ARCH SMOKE FAILED: {failures}")
        sys.exit(1)
    log("arch smoke: all families greedy-identical auto vs xla on "
        f"{jax.default_backend()}")


if __name__ == "__main__":
    main()
