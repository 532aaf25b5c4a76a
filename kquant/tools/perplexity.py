"""Perplexity harness (wikitext-2 style sliding windows).

The north-star quality metric (BASELINE.json): Q4_K_M ppl delta vs fp16 must
stay within llama.cpp's published ~+0.05. The reference never measures ppl
(SURVEY.md section 4 item 5 calls this out as a gap not to copy) — this tool
closes it.
"""

from __future__ import annotations

import math
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np


def nll_of_window(engine, tokens: list[int]) -> tuple[float, int]:
    """Sum negative log-likelihood of tokens[1:] given the prefix, and count."""
    cache = engine.new_cache(1)
    T = len(tokens)
    toks = jnp.asarray([tokens], jnp.int32)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (1, T))
    logits, _ = engine._step(engine.params, toks, positions, cache, False)
    logp = jax.nn.log_softmax(logits[0, : T - 1].astype(jnp.float32), axis=-1)
    tgt = toks[0, 1:]
    nll = -jnp.take_along_axis(logp, tgt[:, None], axis=1).sum()
    return float(nll), T - 1


def perplexity(
    engine,
    token_stream: Iterable[int],
    ctx: int = 512,
    stride: int | None = None,
    max_windows: int | None = None,
) -> dict:
    """Sliding-window perplexity over a token stream.

    Non-overlapping windows by default (llama.cpp perplexity tool semantics:
    chunked ctx-sized windows, all positions after the first scored).
    """
    toks = list(token_stream)
    stride = stride or ctx
    total_nll, total_cnt, n_win = 0.0, 0, 0
    for start in range(0, max(1, len(toks) - 1), stride):
        window = toks[start : start + ctx]
        if len(window) < 2:
            break
        nll, cnt = nll_of_window(engine, window)
        total_nll += nll
        total_cnt += cnt
        n_win += 1
        if max_windows and n_win >= max_windows:
            break
    ppl = math.exp(total_nll / max(1, total_cnt))
    return {"ppl": ppl, "nll_per_token": total_nll / max(1, total_cnt),
            "tokens": total_cnt, "windows": n_win}


def main():
    import argparse

    ap = argparse.ArgumentParser(description="perplexity over a text file")
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", required=True, help="path to raw text file")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--impl", default="auto")
    args = ap.parse_args()

    from kquant.runtime import InferenceEngine, load_model
    from kquant.tokenizer import from_gguf_metadata

    cfg, params, reader = load_model(args.model)
    tok = from_gguf_metadata(reader.metadata)
    text = open(args.text, encoding="utf-8").read()
    ids = tok.encode(text, add_bos=True)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=args.ctx, impl=args.impl)
    res = perplexity(eng, ids, ctx=args.ctx, max_windows=args.max_windows)
    print(f"ppl = {res['ppl']:.4f} over {res['tokens']} tokens ({res['windows']} windows)")


if __name__ == "__main__":
    main()
