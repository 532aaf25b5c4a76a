"""llama-bench-equivalent CLI: pp/tg tests, mean ± σ markdown table.

Mirrors the reference's measurement harness and output format
(SURVEY.md 2.1 "llama-bench tool"; table format at reference README.md:190-196):

| model | size | params | backend | test | t/s |
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def run_bench(model_path: str, pp: int, tg: int, batch: int, reps: int, impl: str,
              scale_dtype: str = "bf16"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kquant.runtime import InferenceEngine, load_model

    cfg, params, reader = load_model(model_path, scale_dtype=scale_dtype)
    n_params = sum(
        int(np.prod(ti.shape)) for ti in reader.tensors.values()
    )
    size_mib = os.path.getsize(model_path) / (1 << 20)
    eng = InferenceEngine(cfg, params, max_batch=batch,
                          max_seq=min(cfg.max_seq_len, pp + tg + 64), impl=impl)
    rng = np.random.default_rng(0)

    sync = jax.block_until_ready

    pps, tgs = [], []
    for rep in range(reps + 1):  # rep 0 = warmup/compile
        prompt = rng.integers(10, cfg.vocab_size, pp).tolist()
        rows = [prompt] * batch
        cache = eng.new_cache(batch)
        jax.block_until_ready(cache)
        t0 = time.time()
        logits, cache, lens = eng.prefill(rows, cache)
        sync(logits)
        pp_tps = pp * batch / (time.time() - t0)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        t0 = time.time()
        toks, cache = eng.decode_greedy_jit(tok, jnp.asarray(lens), cache, tg)
        sync(toks)
        tg_tps = tg * batch / (time.time() - t0)
        if rep > 0:
            pps.append(pp_tps)
            tgs.append(tg_tps)
    return cfg, size_mib, n_params, pps, tgs


def fmt_row(name, size_mib, n_params, backend, test, vals):
    mean = statistics.mean(vals)
    sd = statistics.stdev(vals) if len(vals) > 1 else 0.0
    return (f"| {name} | {size_mib:.2f} MiB | {n_params/1e9:.2f} B | {backend} "
            f"| {test} | {mean:.2f} ± {sd:.2f} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description="kquant bench (llama-bench format)")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("-p", "--pp", type=int, default=512)
    ap.add_argument("-n", "--tg", type=int, default=128)
    ap.add_argument("-b", "--batch", type=int, default=1)
    ap.add_argument("-r", "--reps", type=int, default=3)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--scale-dtype", default="bf16", choices=["bf16", "f32", "f16"])
    args = ap.parse_args(argv)

    from kquant.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax

    backend = jax.default_backend()
    cfg, size_mib, n_params, pps, tgs = run_bench(
        args.model, args.pp, args.tg, args.batch, args.reps, args.impl,
        args.scale_dtype,
    )
    name = f"{cfg.arch} {n_params/1e9:.1f}B Q4_K_M"
    print("| model | size | params | backend | test | t/s |")
    print("| ----- | ---: | -----: | ------- | ---- | --: |")
    print(fmt_row(name, size_mib, n_params, backend, f"pp{args.pp}", pps))
    print(fmt_row(name, size_mib, n_params, backend, f"tg{args.tg}", tgs))


if __name__ == "__main__":
    main()
