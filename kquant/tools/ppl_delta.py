"""Quantization-quality harness: perplexity delta, token-level KL and top-1
agreement between precisions, across the whole recipe ladder.

The north-star quality gate (BASELINE.json): Q4_K_M must stay within
llama.cpp's ~+0.05 ppl of fp16 on wikitext-2. The r3 verdict found the
ppl-only gate SATURATED on the well-trained tiny fixture (+0.0000 deltas —
it would pass a quantizer costing a real model +0.04), so the harness also
measures distribution-level damage that ppl integrates away:

  * mean token KL(p_f16 || p_q) over every teacher-forced position
  * top-1 agreement (argmax match rate) vs the f16 model
  * the full recipe ladder in one run (--types q2_k,q3_k_m,...) so the
    EXPECTED ORDERING (q2 > q3 > q4 > q5 > q6 > q8 damage) is demonstrated,
    not assumed.

  python -m kquant.tools.ppl_delta --model f16.gguf --text wiki.txt \
      --types q2_k,q3_k_m,q4_k_m,q5_k_m,q6_k,q8_0 --ctx 256
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np


class _LPStore:
    """Per-window teacher-forced log-probs, f16 on a disk-backed memmap.

    The r4 in-RAM f32 list OOMed on real corpora (wikitext-2 at 32k vocab /
    ctx 512 is tens of GB); f16 halves the bytes and the memmap keeps them
    off the heap entirely — the ladder's base run streams to disk once, then
    every quantized run reads it back window by window."""

    def __init__(self, nw: int, ctx: int, vocab: int):
        f = tempfile.NamedTemporaryFile(suffix=".lp.f16", delete=False)
        self._path = f.name
        f.close()
        self._mm = np.memmap(self._path, np.float16, "w+", shape=(nw, ctx, vocab))
        self._ts: list[int] = []

    def append(self, lp: np.ndarray) -> None:
        w, t = len(self._ts), lp.shape[0]
        self._mm[w, :t] = lp.astype(np.float16)
        self._ts.append(t)

    def get(self, w: int) -> np.ndarray:
        blp = np.asarray(self._mm[w, : self._ts[w]], np.float32)
        # f16 rounding denormalizes the stored distribution slightly (KL
        # against it could go ~1e-5 negative); renormalize on read
        m = blp.max(-1, keepdims=True)
        blp -= m + np.log(np.exp(blp - m).sum(-1, keepdims=True))
        return blp

    def close(self) -> None:
        del self._mm
        Path(self._path).unlink(missing_ok=True)


def window_metrics(model_path: str, ids, ctx: int, max_windows, impl: str,
                   base_lp: _LPStore | None = None):
    """Teacher-forced per-window log-probs + metrics.

    Returns (ppl, mean_kl, top1_agreement, logprob_store). When base_lp is
    given (the f16 run's windows), KL/top-1 are computed against it and
    logprob_store is None."""
    import jax
    import jax.numpy as jnp

    from kquant.runtime import InferenceEngine, load_model

    cfg, params, reader = load_model(model_path)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=ctx, impl=impl)
    nw = max((len(ids) - 1) // ctx, 1)
    if max_windows:
        nw = min(nw, max_windows)
    nll = 0.0
    cnt = 0
    kl_sum = 0.0
    agree = 0
    lps = _LPStore(nw, ctx, cfg.vocab_size) if base_lp is None else None
    for w in range(nw):
        seg = np.asarray(ids[w * ctx: w * ctx + ctx + 1], np.int32)
        if len(seg) < 2:
            break
        T = len(seg) - 1
        toks = jnp.asarray(seg[:-1][None, :])
        pos = jnp.arange(T, dtype=jnp.int32)[None, :]
        cache = eng.new_cache(1)
        logits, _ = eng._step(eng.params, toks, pos, cache, False)
        lp = np.asarray(jax.nn.log_softmax(logits[0].astype(jnp.float32),
                                           axis=-1))
        tgt = seg[1:]
        nll += float(-lp[np.arange(T), tgt].sum())
        cnt += T
        if base_lp is not None:
            blp = base_lp.get(w)
            kl_sum += float(
                (np.exp(blp) * (blp - lp)).sum(-1).sum())
            agree += int((blp.argmax(-1) == lp.argmax(-1)).sum())
        else:
            lps.append(lp)
    reader.close()
    ppl = float(np.exp(nll / max(cnt, 1)))
    if base_lp is not None:
        return ppl, kl_sum / max(cnt, 1), agree / max(cnt, 1), None
    return ppl, 0.0, 1.0, lps


def main(argv=None):
    ap = argparse.ArgumentParser(description="ppl/KL/top-1 delta across quantizations")
    ap.add_argument("--model", required=True, help="high-precision GGUF (f16/f32)")
    ap.add_argument("--text", required=True)
    ap.add_argument("--type", default=None, help="single recipe (legacy mode)")
    ap.add_argument("--types", default=None,
                    help="comma list for the ladder table")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)

    from kquant.gguf import GGUFReader
    from kquant.tokenizer import from_gguf_metadata
    from kquant.tools.quantize import requantize

    with GGUFReader(args.model) as r:
        tok = from_gguf_metadata(r.metadata)
    ids = tok.encode(open(args.text, encoding="utf-8").read(), add_bos=True)

    types = (args.types.split(",") if args.types
             else [args.type or "q4_k_m"])

    base_ppl, _, _, base_lp = window_metrics(
        args.model, ids, args.ctx, args.max_windows, args.impl)
    print(f"base ppl   : {base_ppl:.4f}")
    rows = []
    for t in types:
        with tempfile.TemporaryDirectory() as td:
            qpath = str(Path(td) / "q.gguf")
            requantize(args.model, qpath, t, verbose=False)
            q_ppl, kl, top1, _ = window_metrics(
                qpath, ids, args.ctx, args.max_windows, args.impl,
                base_lp=base_lp)
        print(f"{t:10s}: ppl {q_ppl:.4f}  dppl {q_ppl - base_ppl:+.4f}  "
              f"KL {kl:.5f}  top1 {top1 * 100:.2f}%")
        rows.append({"type": t, "ppl": round(q_ppl, 4),
                     "dppl": round(q_ppl - base_ppl, 4),
                     "kl": round(kl, 6), "top1": round(top1, 4)})
    base_lp.close()
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(
            {"base_ppl": round(base_ppl, 4), "rows": rows}, indent=1))
    if len(rows) == 1:
        return rows[0]["dppl"]
    return rows


if __name__ == "__main__":
    main()
