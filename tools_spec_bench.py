#!/usr/bin/env python
"""Speculative-decoding benchmark.

The loop is DEVICE-RESIDENT (runtime.speculative.DeviceSpeculator) — draft
+ verify + accept/reject + emit run inside one jitted while_loop and the host
dispatches once per generation. Timing is MARGINAL: two runs of different
lengths through the SAME executable, (t_big - t_small) / (tok_big -
tok_small), which cancels prefill and dispatch exactly.

Configs:
  plain         fused greedy decode chain (the baseline rate)
  lookup        n-gram prompt-lookup draft (free!) on a prompt seeded with
                the model's own generated cycle — the repetitive-text win
                condition (llama.cpp tools/lookup equivalent)
  lookup-rand   same draft on a random prompt (worst case: ~0 acceptance;
                cost floor of the machinery when the draft never lands)
  alpha1-free   accept_all bound with the free draft: every round takes
                n_draft+1 tokens for ONE verify forward — the machinery
                ceiling (timing-only; outputs are draft-quality)
  self          two-model with draft = target (alpha~1 but full draft cost)
  truncated-kL  two-model early-exit draft (first k layers + target head)

  python tools_spec_bench.py --drafts lookup alpha1-free self 4 --n-draft 6
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--drafts", nargs="+",
                    default=["lookup", "lookup-rand", "alpha1-free", "self",
                             "4"],
                    help="configs: lookup | lookup-rand | alpha1-free | "
                         "self | <k> (truncated k-layer draft)")
    ap.add_argument("--n-draft", type=int, default=6)
    ap.add_argument("--gen", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--json-out", default="")
    args = ap.parse_args()

    enable_compile_cache()
    from bench import get_fixture
    from kquant.models.fixtures import tinyllama_1b_config
    from kquant.runtime import InferenceEngine, load_model

    model_path = args.model or get_fixture("tinyllama-1.1b-q4_k_m",
                                           tinyllama_1b_config())
    cfg, params, _ = load_model(model_path, scale_dtype="bf16")
    log(f"devices: {jax.devices()}  arch={cfg.arch} L={cfg.n_layers}")

    max_seq = args.prompt_len + args.gen + args.n_draft + 16
    target = InferenceEngine(cfg, params, max_batch=1, max_seq=max_seq)
    rng = np.random.default_rng(0)
    prompt = rng.integers(10, cfg.vocab_size - 10, args.prompt_len).tolist()

    sync = jax.block_until_ready

    # plain greedy baseline: marginal device time per token (fused chain)
    @partial(jax.jit, donate_argnums=(3,))
    def tg_chain(p, tok, pos, cache, n):
        def body(_i, carry):
            tok, pos, cache = carry
            logits, cache = target._step(p, tok[:, None], pos[:, None],
                                         cache, True)
            return (jnp.argmax(logits[:, 0, :], axis=-1).astype(jnp.int32),
                    pos + 1, cache)
        return jax.lax.fori_loop(0, n, body, (tok, pos, cache))

    cache = target.new_cache(1)
    tok = jnp.zeros((1,), jnp.int32)
    pos = jnp.full((1,), args.prompt_len, jnp.int32)
    tok, pos, cache = tg_chain(target.params, tok, pos, cache, 4)
    sync(tok)
    t0 = time.time()
    tok, pos, cache = tg_chain(target.params, tok, pos, cache, 32)
    sync(tok)
    t1 = time.time() - t0
    t0 = time.time()
    tok, pos, cache = tg_chain(target.params, tok, pos, cache, 64)
    sync(tok)
    t2 = time.time() - t0
    plain_per_tok = max(t2 - t1, 1e-9) / 32
    log(f"plain greedy decode: {plain_per_tok*1e6:.0f} us/tok device "
        f"({1/plain_per_tok:.1f} t/s)")

    # a prompt seeded with the model's own greedy cycle: the continuation
    # repeats it, so n-gram lookups land (the repetitive-text regime
    # prompt-lookup exists for); generated ONCE from the random prompt
    cyc = target.generate([prompt], max_new_tokens=64)[0]
    prompt_cyclic = (prompt + cyc)[-args.prompt_len * 2:]

    from kquant.runtime.speculative import DeviceSpeculator

    rows = [{"config": "plain", "tok_s_device": round(1 / plain_per_tok, 1)}]
    gen_small = max(16, args.gen // 3)
    for d in args.drafts:
        p = prompt
        if d == "lookup":
            sp = DeviceSpeculator(target, None, n_draft=args.n_draft)
            label, p = "lookup-ngram (cyclic text)", prompt_cyclic
        elif d == "lookup-rand":
            sp = DeviceSpeculator(target, None, n_draft=args.n_draft)
            label = "lookup-ngram (random text)"
        elif d == "alpha1-free":
            sp = DeviceSpeculator(target, None, n_draft=args.n_draft,
                                  accept_all=True)
            label = "alpha=1 bound (free draft)"
        elif d == "self":
            draft = InferenceEngine(cfg, params, max_batch=1, max_seq=max_seq)
            sp = DeviceSpeculator(target, draft, n_draft=args.n_draft)
            label = "self (two-model alpha~1)"
        else:
            k = int(d)
            d_cfg = dataclasses.replace(cfg, n_layers=k)
            d_params = {**params, "layers": params["layers"][:k]}
            draft = InferenceEngine(d_cfg, d_params, max_batch=1,
                                    max_seq=max_seq)
            sp = DeviceSpeculator(target, draft, n_draft=args.n_draft)
            label = f"truncated-{k}L"
        # warm the one executable, then MARGINAL timing: the big and small
        # runs share prefill + dispatch structure, so the difference is
        # pure device loop time
        sp.generate([p], max_new_tokens=8)
        t0 = time.time()
        out_s, stats_s = sp.generate([p], max_new_tokens=gen_small)
        t_small = time.time() - t0
        t0 = time.time()
        out, stats = sp.generate([p], max_new_tokens=args.gen)
        t_big = time.time() - t0
        ntok, ntok_s = len(out[0]), len(out_s[0])
        per_tok = max(t_big - t_small, 1e-9) / max(ntok - ntok_s, 1)
        acc = stats["accepted"] / max(stats["drafted"], 1)
        row = {
            "config": label, "n_draft": args.n_draft, "tokens": ntok,
            "rounds": stats["rounds"], "acceptance": round(acc, 3),
            "tokens_per_round": round(ntok / max(stats["rounds"], 1), 2),
            "tok_s_wall": round(ntok / t_big, 1),
            "tok_s_device_marginal": round(1 / per_tok, 1),
            "speedup_vs_plain_device": round(plain_per_tok / per_tok, 2),
        }
        log(f"{label:28s} acceptance {acc:.2f}  "
            f"{row['tokens_per_round']:.2f} tok/round  "
            f"{row['tok_s_device_marginal']:8.1f} t/s device  "
            f"(x{row['speedup_vs_plain_device']:.2f} vs plain)")
        rows.append(row)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
