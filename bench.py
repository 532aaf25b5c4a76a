#!/usr/bin/env python
"""Headline benchmark: single-stream decode tokens/sec/chip on TinyLlama-1.1B
Q4_K_M — the reference's exact workload (BASELINE.md: llama-bench tg128 =
9.65 t/s after its NEON optimization on a Raspberry Pi 5).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "tok/s", "vs_baseline": N/9.65,
   "device": {"platform", "kind", "count", "cards"}, ...}

Runs on the GPU only: a measurement that finds no accelerator fails. Rates
are host-clock times of work that ends in ``block_until_ready``; compile
time is reported apart, as set-up.

The model is a synthesized GGUF with TinyLlama-1.1B's exact architecture and
Q4_K_M type recipe (zero-egress environment: no weights download; identical
tensor inventory, bytes and compute graph as the real checkpoint). Cached
under .cache/ after first build.
"""

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BASELINE_TG128 = 9.65  # reference README.md:1488 (post-optimization tg128)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def get_fixture(name: str, cfg, seed: int = 0) -> str:
    """The preset's GGUF under .cache/ (shared with chip_smoke.py), built
    once from ``seed``."""
    cache = REPO / ".cache"
    cache.mkdir(exist_ok=True)
    path = cache / f"{name}-rand{seed}.gguf"
    if not path.exists():
        log(f"building fixture {path} ...")
        from kquant.models.fixtures import write_fixture_gguf

        t0 = time.time()
        write_fixture_gguf(path, cfg, seed=seed, quant="q4_k_m",
                           random_codes=True)
        log(f"set-up: fixture built in {time.time() - t0:.1f}s")
    return str(path)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None, help="path to a GGUF model (default: TinyLlama-1.1B fixture)")
    ap.add_argument("--preset", default="tinyllama-1.1b",
                    choices=["tinyllama-1.1b", "llama3-8b"],
                    help="fixture model to synthesize when --model is not given")
    ap.add_argument("--pp", type=int, default=512, help="prefill tokens")
    ap.add_argument("--tg", type=int, default=128, help="decode tokens")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--impl", default="auto", choices=["auto", "xla", "pallas"])
    ap.add_argument("--scale-dtype", default="bf16", choices=["bf16", "f32", "f16"],
                    help="per-group scale/min storage (bf16 = fewer bytes/weight)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions (compile warmup excluded; "
                         "mean±σ + median reported, reference README style)")
    ap.add_argument("--scan-layers", action="store_true",
                    help="lax.scan over stacked layers (one compiled layer "
                         "instead of L inlined copies; the 70B-class config)")
    args = ap.parse_args()

    from kquant.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kquant.utils.device import describe

    dev = describe()
    log(f"device: {dev}")
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev['platform']}")

    from functools import partial

    from kquant.models.fixtures import llama3_8b_config, tinyllama_1b_config
    from kquant.runtime import InferenceEngine, load_model
    from kquant.utils.roofline import prefill_roofline_report, roofline_report

    preset_cfg = {
        "tinyllama-1.1b": ("tinyllama-1.1b-q4_k_m", tinyllama_1b_config),
        "llama3-8b": ("llama3-8b-q4_k_m", llama3_8b_config),
    }[args.preset]
    model_path = args.model or get_fixture(preset_cfg[0], preset_cfg[1]())
    t0 = time.time()
    cfg, params, _ = load_model(model_path, scale_dtype=args.scale_dtype)
    log(f"model loaded+repacked in {time.time() - t0:.1f}s  arch={cfg.arch} "
        f"L={cfg.n_layers} dim={cfg.dim} vocab={cfg.vocab_size}")

    B = args.batch
    max_seq = min(cfg.max_seq_len, args.pp + args.tg + 64)
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=max_seq,
                          impl=args.impl, scan_layers=args.scan_layers)
    rng = np.random.default_rng(0)

    @partial(jax.jit, donate_argnums=(3,))
    def tg_chain(params, tok, pos, cache, n):
        """n greedy decode steps in one dispatch (fori_loop, traced n)."""

        def body(_i, carry):
            tok, pos, cache = carry
            logits, cache = eng._step(params, tok[:, None], pos[:, None],
                                      cache, True)
            ntok = jnp.argmax(logits[:, 0, :], axis=-1).astype(jnp.int32)
            return ntok, pos + 1, cache

        return jax.lax.fori_loop(0, n, body, (tok, pos, cache))

    def prefill(rows):
        cache = jax.block_until_ready(eng.new_cache(B))
        t0 = time.perf_counter()
        logits, cache, lens = eng.prefill(rows, cache)
        jax.block_until_ready(logits)
        return time.perf_counter() - t0, logits, cache, lens

    def decode(logits, cache, lens):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos = jnp.asarray(lens)
        t0 = time.perf_counter()
        out = tg_chain(eng.params, tok, pos, cache, args.tg)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    # compile warm-up, excluded from the statistics and reported as set-up
    warm = [rng.integers(10, cfg.vocab_size, args.pp).tolist()] * B
    dt, logits, cache, lens = prefill(warm)
    log(f"set-up: prefill compile + first run {dt:.1f}s")
    dt = decode(logits, cache, lens)
    log(f"set-up: decode chain compile + first run {dt:.1f}s")

    results: dict = {"pp": [], "tg": []}
    for rep in range(args.reps):
        rows = [rng.integers(10, cfg.vocab_size, args.pp).tolist()] * B
        pp_dt, logits, cache, lens = prefill(rows)
        tg_dt = decode(logits, cache, lens)
        results["pp"].append(args.pp * B / pp_dt)
        results["tg"].append(args.tg * B / tg_dt)
        log(f"rep {rep}: pp{args.pp} {results['pp'][-1]:8.1f} t/s   "
            f"tg{args.tg} {results['tg'][-1]:8.1f} t/s")

    tg = float(np.median(results["tg"]))
    pp = float(np.median(results["pp"]))
    tg_mean, tg_std = float(np.mean(results["tg"])), float(np.std(results["tg"]))
    pp_mean, pp_std = float(np.mean(results["pp"])), float(np.std(results["pp"]))
    log(f"pp{args.pp}: {pp_mean:.1f} ± {pp_std:.1f} t/s   "
        f"tg{args.tg}: {tg_mean:.1f} ± {tg_std:.1f} t/s over {args.reps} reps")
    rep = roofline_report(params, cfg, tg, device_kind=dev["kind"], batch=B,
                          seq_len=args.pp + args.tg)
    log(f"decode roofline: {rep['bytes_per_step']/1e6:.0f} MB/step -> "
        f"{rep['roofline_tok_s']:.0f} tok/s ceiling; measured "
        f"{tg:.0f} = {rep['fraction_of_roofline']*100:.1f}% of the "
        f"published peak ({dev['cards']})")
    prep = prefill_roofline_report(params, cfg, pp, T=args.pp,
                                   device_kind=dev["kind"], batch=B)
    log(f"prefill roofline ({prep['bound']}-bound): "
        f"{prep['flops_per_token']/1e9:.2f} GFLOP/tok -> "
        f"{prep['roofline_tok_s']:.0f} tok/s ceiling; measured "
        f"{pp:.0f} = {prep['fraction_of_roofline']*100:.1f}% of the "
        f"published peak")
    name = args.preset if args.model is None else os.path.basename(args.model)
    print(json.dumps({
        "metric": f"tg{args.tg} decode tok/s, {name} Q4_K_M batch {B}",
        "value": tg,
        "unit": "tok/s",
        "vs_baseline": tg / BASELINE_TG128,
        "mean": tg_mean, "stddev": tg_std,
        "pp_mean": pp_mean, "pp_stddev": pp_std, "pp_median": pp,
        "decode_roofline_frac": rep["fraction_of_roofline"],
        "prefill_roofline_frac": prep["fraction_of_roofline"],
        "reps": args.reps, "impl": args.impl, "device": dev,
    }))


if __name__ == "__main__":
    main()
