#!/usr/bin/env python
"""Continuous-batching serving benchmark. Drives the ContinuousBatcher with
a closed-loop offered load at batch sizes B, reporting decode tokens/s on the
host clock and average occupancy.

Usage: python tools_serve_bench.py [--preset tinyllama-1.1b] [--batch 8 16]
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--preset", default="tinyllama-1.1b",
                    choices=["tinyllama-1.1b", "llama3-8b"])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests per batch-size run (0 = 4*B, so "
                         "the steady state actually saturates the batch)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="serve over the int8-quantized KV cache")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--impl", default="auto")
    args = ap.parse_args()

    from kquant.utils.cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np

    from bench import get_fixture
    from kquant.models.fixtures import llama3_8b_config, tinyllama_1b_config
    from kquant.runtime import InferenceEngine, load_model
    from kquant.serving import ContinuousBatcher, Request
    from kquant.utils.device import describe

    preset_cfg = {
        "tinyllama-1.1b": ("tinyllama-1.1b-q4_k_m", tinyllama_1b_config),
        "llama3-8b": ("llama3-8b-q4_k_m", llama3_8b_config),
    }[args.preset]
    model_path = args.model or get_fixture(preset_cfg[0], preset_cfg[1]())
    cfg, params, _ = load_model(model_path)
    dev = describe()
    log(f"device: {dev}  arch={cfg.arch} L={cfg.n_layers}")

    rng = np.random.default_rng(0)
    rows = []
    for B in args.batch:
        n_req = args.requests or 4 * B
        max_seq = args.prompt_len + args.gen_len + 16
        eng = InferenceEngine(cfg, params, max_batch=B, max_seq=max_seq,
                              impl=args.impl, kv_quantized=args.kv_int8)
        cb = ContinuousBatcher(eng, seed=0)

        def mk_req(i):
            plen = args.prompt_len // 2 + int(rng.integers(0, args.prompt_len // 2))
            return Request(
                prompt=rng.integers(10, cfg.vocab_size, plen).tolist(),
                max_new_tokens=args.gen_len,
                temperature=args.temperature, top_k=40, top_p=0.95,
                repeat_penalty=1.1, penalty_last_n=64, seed=1000 + i,
            )

        # warmup: compile decode + BOTH slot-prefill buckets + sampler +
        # the multi-tick chunk executables + BOTH admission shapes (the
        # initial k=B burst and steady-state k=1) the main run will hit
        for i in range(B + 2):
            r = mk_req(10_000 + i)
            plen = args.prompt_len // 2 if i % 2 else args.prompt_len
            r.prompt = rng.integers(10, cfg.vocab_size, plen).tolist()
            cb.submit(r)
        cb.run()
        cb.stats = {k: 0 if not isinstance(v, float) else 0.0
                    for k, v in cb.stats.items()}

        for i in range(n_req):
            cb.submit(mk_req(i))
        t0 = time.time()
        done = cb.run()
        wall = time.time() - t0
        assert len(done) == n_req
        rep = cb.report()
        log(f"B={B:3d}: {rep['tokens_out']} tokens in {wall:.1f}s = "
            f"{rep['tokens_out']/wall:7.1f} t/s wall | occupancy "
            f"{rep['avg_batch_occupancy']:.1f}/{B} | {rep['prefills']} prefills")
        rows.append({
            "batch": B, "tok_s_wall": rep["tokens_out"] / wall,
            "occupancy": rep["avg_batch_occupancy"],
            "tokens_out": rep["tokens_out"], "requests": n_req,
            "dispatches": rep.get("dispatches"),
            "kv_int8": args.kv_int8,
        })
    print(json.dumps({"serving": rows, "preset": args.preset, "device": dev,
                      "gen_len": args.gen_len, "prompt_len": args.prompt_len}))


if __name__ == "__main__":
    main()
