#!/usr/bin/env python
"""Capture a DEVICE timeline trace of the fused decode loop (and optionally a
serving tick) and emit per-HLO-op attribution — the committed flame.svg /
out.folded analog (reference: /root/reference/README.md:246-269).

Uses jax.profiler + the pure-python xplane reader (kquant/utils/xplane.py).

  python tools_trace_decode.py --steps 32 --out-prefix .cache/trace_decode
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax

import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--serving", action="store_true",
                    help="also trace one serving scheduler tick at B=8")
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--prefill", type=int, default=0,
                    help="trace ONE prefill of this many tokens instead of "
                         "the decode loop")
    ap.add_argument("--out-prefix", default=".cache/trace_decode")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args()

    from kquant.utils.cache import enable_compile_cache

    enable_compile_cache()
    from bench import get_fixture
    from kquant.models.fixtures import tinyllama_1b_config
    from kquant.runtime import InferenceEngine, load_model
    from kquant.utils.xplane import device_op_table, find_xplane, folded_stacks

    model_path = args.model or get_fixture("tinyllama-1.1b-q4_k_m", tinyllama_1b_config())
    cfg, params, _reader = load_model(model_path, scale_dtype="bf16")
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=args.max_seq,
                          kv_quantized=args.kv_int8)
    log(f"loaded {cfg.arch} L={cfg.n_layers}")

    rng = np.random.default_rng(0)
    if args.prefill:
        # warm the prefill bucket, then trace ONE prefill dispatch
        toks = [list(rng.integers(10, cfg.vocab_size - 10, args.prefill))]
        cache = eng.new_cache(1)
        logits, cache, _ = eng.prefill(toks, cache)
        jax.block_until_ready(logits)
        cache = eng.new_cache(1)
        tdir = tempfile.mkdtemp(prefix="tkq_trace_pp_")
        with jax.profiler.trace(tdir):
            logits, cache, _ = eng.prefill(toks, cache)
            jax.block_until_ready(logits)
        n_steps = 1
    else:
        toks = [list(rng.integers(10, cfg.vocab_size - 10, args.prompt_len))]
        cache = eng.new_cache(1)
        logits, cache, lens = eng.prefill(toks, cache)
        first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos = jnp.asarray(lens)

        # warm the decode loop executable OUTSIDE the trace
        out, cache = eng.decode_greedy_jit(first, pos, cache, args.steps)
        jax.block_until_ready(out)

        tdir = tempfile.mkdtemp(prefix="tkq_trace_")
        with jax.profiler.trace(tdir):
            out, cache = eng.decode_greedy_jit(first, pos + args.steps, cache,
                                               args.steps)
            jax.block_until_ready(out)
        n_steps = args.steps

    rows, total = device_op_table(tdir, top=0)
    per_step = {"steps": n_steps, "total_device_us": round(total, 1),
                "us_per_step": round(total / n_steps, 1)}
    log(f"device total {total:.1f} us over {n_steps} steps "
        f"= {total/n_steps:.1f} us/step")
    table = []
    for n, us, c in rows[: args.top]:
        log(f"{us:9.1f} us  x{c:5d}  {us/n_steps:7.2f}/step  {n[:90]}")
        table.append({"op": n[:200], "us": round(us, 1), "count": c,
                      "us_per_step": round(us / n_steps, 2)})

    prefix = Path(args.out_prefix)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    Path(f"{prefix}_ops.json").write_text(
        json.dumps({"summary": per_step, "ops": table}, indent=1))
    Path(f"{prefix}.folded").write_text(folded_stacks(tdir))
    shutil.copy(find_xplane(tdir), f"{prefix}.xplane.pb")
    log(f"wrote {prefix}_ops.json / .folded / .xplane.pb")

    if args.serving:
        from kquant.serving.scheduler import ContinuousBatcher, Request

        eng8 = InferenceEngine(cfg, params, max_batch=8, max_seq=512)
        sched = ContinuousBatcher(eng8)
        for i in range(8):
            sched.submit(Request(
                prompt=list(rng.integers(10, cfg.vocab_size - 10, 32)),
                max_new_tokens=64))
        for _ in range(4):  # warm tick executables
            sched.step()
        tdir2 = tempfile.mkdtemp(prefix="tkq_trace_serve_")
        with jax.profiler.trace(tdir2):
            for _ in range(4):
                sched.step()
        rows, total = device_op_table(tdir2, top=0)
        log(f"serving: device total {total:.1f} us over 4 ticks")
        table = [{"op": n[:200], "us": round(us, 1), "count": c}
                 for n, us, c in rows[: args.top]]
        Path(f"{prefix}_serving_ops.json").write_text(json.dumps(
            {"summary": {"ticks": 4, "total_device_us": round(total, 1)},
             "ops": table}, indent=1))
        shutil.copy(find_xplane(tdir2), f"{prefix}_serving.xplane.pb")
        log(f"wrote {prefix}_serving_ops.json / _serving.xplane.pb")


if __name__ == "__main__":
    main()
