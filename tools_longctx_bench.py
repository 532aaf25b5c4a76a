#!/usr/bin/env python
"""Long-context decode sweep: marginal tg rate at context S for bf16 vs int8
KV (the longctx_decode table; r3's was a one-off, this is the committed tool).

  python tools_longctx_bench.py --seqs 768 4096 8192 16384
  python tools_longctx_bench.py --preset llama3-8b --seqs 4096 8192
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax
import jax.numpy as jnp
import numpy as np

from kquant.utils.cache import enable_compile_cache


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--preset", default="tinyllama-1.1b",
                    choices=["tinyllama-1.1b", "llama3-8b"])
    ap.add_argument("--seqs", type=int, nargs="+",
                    default=[768, 4096, 8192, 16384])
    ap.add_argument("--kv", nargs="+", default=["bf16", "int8"])
    ap.add_argument("--tg", type=int, default=128)
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()

    enable_compile_cache()
    from bench import get_fixture
    from kquant.models.fixtures import llama3_8b_config, tinyllama_1b_config
    from kquant.runtime import InferenceEngine, load_model
    from kquant.utils.roofline import roofline_report

    preset_cfg = {
        "tinyllama-1.1b": ("tinyllama-1.1b-q4_k_m", tinyllama_1b_config),
        "llama3-8b": ("llama3-8b-q4_k_m", llama3_8b_config),
    }[args.preset]
    model_path = args.model or get_fixture(preset_cfg[0], preset_cfg[1]())
    cfg, params, _ = load_model(model_path, scale_dtype="bf16")
    kind = jax.devices()[0].device_kind
    log(f"devices: {jax.devices()}  arch={cfg.arch} L={cfg.n_layers}")
    sync = jax.block_until_ready

    half = args.tg // 2
    rows = []
    for S in args.seqs:
        for kv in args.kv:
            eng = InferenceEngine(cfg, params, max_batch=1, max_seq=S + 8,
                                  kv_quantized=(kv == "int8"))

            @partial(jax.jit, donate_argnums=(3,))
            def tg_chain(p, tok, pos, cache, n):
                def body(_i, carry):
                    tok, pos, cache = carry
                    logits, cache = eng._step(p, tok[:, None], pos[:, None],
                                              cache, True)
                    ntok = jnp.argmax(logits[:, 0, :], axis=-1).astype(
                        jnp.int32)
                    return ntok, pos + 1, cache
                return jax.lax.fori_loop(0, n, body, (tok, pos, cache))

            cache = eng.new_cache(1)
            tok = jnp.zeros((1,), jnp.int32)
            pos = jnp.full((1,), S - args.tg - 4, jnp.int32)
            # warm (compile) + measure marginal over chain lengths
            tok, pos, cache = tg_chain(eng.params, tok, pos, cache, 2)
            sync(tok)
            t0 = time.time()
            tok, pos, cache = tg_chain(eng.params, tok, pos, cache, half)
            sync(tok)
            t1 = time.time() - t0
            t0 = time.time()
            tok, pos, cache = tg_chain(eng.params, tok, pos, cache, args.tg)
            sync(tok)
            t2 = time.time() - t0
            tps = (args.tg - half) / max(t2 - t1, 1e-9)
            rep = roofline_report(params, cfg, tps, device_kind=kind, batch=1,
                                  seq_len=S, kv_quantized=(kv == "int8"))
            log(f"S={S:6d} kv={kv}: {tps:7.1f} t/s  "
                f"(roofline {rep['roofline_tok_s']:.0f}, "
                f"{tps/rep['roofline_tok_s']*100:.0f}%)")
            rows.append({"S": S, "kv": kv, "tok_s": round(tps, 1),
                         "roofline": round(rep["roofline_tok_s"], 1),
                         "frac": round(tps / rep["roofline_tok_s"], 3)})
            del cache, eng
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
