"""Speculative decoding: a small draft model proposes n_draft tokens, the
target model verifies them in ONE batched forward (the llama.cpp
tools/speculative equivalent, built on the same engine primitives).

Greedy verification semantics: a draft token is accepted only while it equals
the target's own argmax, and the first mismatch is replaced by the target's
argmax — so the output sequence is IDENTICAL to plain greedy decoding of the
target model, regardless of draft quality. Draft quality only changes speed:
each round emits between 1 and n_draft + 1 tokens for one target forward.

Static-shape discipline: every round is two fixed-shape dispatches (a fused
lax.scan draft loop of n_draft steps + one (n_draft + 1)-token verify step),
so both executables compile once. Rejected positions leave garbage K/V in
both caches, which is safe under the engine's slot invariant: the next
round's feed always starts at the first unverified position and re-writes
every rejected slot before any query can attend it (engine.py prefill note).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kquant.runtime.engine import InferenceEngine


def generate_speculative(
    target: InferenceEngine,
    draft: InferenceEngine,
    prompts: list[list[int]],
    max_new_tokens: int = 32,
    n_draft: int = 6,
    eos_id: int | None = None,
) -> tuple[list[list[int]], dict]:
    """Greedy speculative generation. Returns (tokens per row, stats).

    stats: {'rounds': N, 'drafted': N, 'accepted': N} — accepted/drafted is
    the draft acceptance rate; tokens/round = emitted / rounds.
    """
    B = len(prompts)
    t_cache = target.new_cache(B)
    d_cache = draft.new_cache(B)

    t_logits, t_cache, lens = target.prefill(prompts, t_cache)
    _, d_cache, _ = draft.prefill(prompts, d_cache)

    # first token comes from the target's prefill logits (greedy)
    cur = jnp.argmax(t_logits, axis=-1).astype(jnp.int32)  # [B]
    pos = jnp.asarray(lens, jnp.int32)  # position of `cur` per row

    out: list[list[int]] = [[int(c)] for c in np.asarray(cur)]
    done = np.zeros(B, bool)
    if eos_id is not None:
        done |= np.asarray(cur) == eos_id
    stats = {"rounds": 0, "drafted": 0, "accepted": 0}

    cap = min(target.max_seq, draft.max_seq)
    while (
        not done.all()
        and min(len(o) for o in out) < max_new_tokens
        and int(pos.max()) + n_draft + 1 < cap
    ):
        stats["rounds"] += 1
        # 1) draft proposes n_draft greedy tokens from (cur, pos)
        d_toks, d_cache = draft.decode_greedy_jit(cur, pos, d_cache, n_draft)
        # 2) target verifies [cur, d_1..d_n] in one forward; logits[i]
        #    predicts the token at pos + 1 + i
        feed = jnp.concatenate([cur[:, None], d_toks], axis=1)  # [B, n+1]
        positions = pos[:, None] + jnp.arange(n_draft + 1, dtype=jnp.int32)
        v_logits, t_cache = target._step(
            target.params, feed, positions, t_cache, False
        )
        t_pred = np.asarray(jnp.argmax(v_logits, axis=-1))  # [B, n+1]
        d_np = np.asarray(d_toks)

        # 3) per-row longest accepted prefix + target correction/bonus token
        accepted = np.zeros(B, np.int32)
        next_tok = np.zeros(B, np.int32)
        for b in range(B):
            k = 0
            while k < n_draft and t_pred[b, k] == d_np[b, k]:
                k += 1
            accepted[b] = k
            next_tok[b] = t_pred[b, k]
            if not done[b]:
                emitted = [int(x) for x in d_np[b, :k]] + [int(t_pred[b, k])]
                for tok in emitted:
                    out[b].append(tok)
                    if eos_id is not None and tok == eos_id:
                        done[b] = True
                        break
        stats["drafted"] += int(n_draft * B)
        stats["accepted"] += int(accepted.sum())

        # 4) advance: next round decodes from the correction token. Rows
        #    advance by different amounts; garbage K/V beyond each row's new
        #    position is overwritten next round before it is attended.
        pos = pos + jnp.asarray(accepted + 1)
        cur = jnp.asarray(next_tok)

    return [o[:max_new_tokens] for o in out], stats


class DeviceSpeculator:
    """DEVICE-RESIDENT speculative decoding: every round (draft + verify +
    accept/reject + emit) runs inside ONE jitted lax.while_loop; the host
    dispatches once per GENERATION and fetches the finished token history.

    A host-driven loop pays two device round trips per round; here rounds
    cost zero host round-trips, so the speedup is governed by real
    arithmetic:
    (accepted + 1) tokens per (draft cost + one (n_draft+1)-token verify).

    Two draft sources:
      * draft engine (two-model): classic target/draft speculation; same
        greedy-identical semantics as generate_speculative above.
      * draft=None (PROMPT-LOOKUP / n-gram): the draft for position p+1 is
        the continuation of the most recent previous occurrence of the
        last ``ngram`` tokens in the row's own history (prompt+output) —
        llama.cpp's tools/lookup equivalent. The draft costs no model at
        all, so any nonzero acceptance is pure win; output remains
        greedy-identical regardless (rejected drafts are replaced by the
        target's own argmax).

    accept_all=True keeps the machinery but skips the accept comparison
    (alpha=1 bound): every round emits n_draft+1 tokens for one verify —
    the ceiling of this machinery; outputs are then draft-quality, so it
    is a TIMING harness only.
    """

    def __init__(self, target: InferenceEngine, draft: InferenceEngine | None,
                 n_draft: int = 6, ngram: int = 3, accept_all: bool = False):
        self.target = target
        self.draft = draft
        self.n_draft = n = n_draft
        self.ngram = g = ngram
        self.accept_all = accept_all
        t_fwd = target._fwd
        d_fwd = draft._fwd if draft is not None else None
        t_cfg, d_cfg = target.cfg, (draft.cfg if draft else None)
        C = target.max_seq

        def _draft_model(d_params, d_cache, cur, pos):
            def body(carry, _):
                tok, p, cache = carry
                logits, cache = d_fwd(d_params, d_cfg, tok[:, None],
                                      p[:, None], cache,
                                      logits_last_only=True)
                ntok = jnp.argmax(logits[:, 0, :], axis=-1).astype(jnp.int32)
                return (ntok, p + 1, cache), ntok

            (_, _, d_cache), toks = jax.lax.scan(
                body, (cur, pos, d_cache), length=n)
            return toks.T, d_cache  # [B, n]

        def _draft_lookup(hist, cur, pos):
            def row(hist_b, pos_b, cur_b):
                idx = jnp.arange(C - g + 1)
                ok = jnp.ones(C - g + 1, bool)
                for j in range(g):
                    gj = hist_b[pos_b - g + 1 + j]
                    ok &= hist_b[j: j + C - g + 1] == gj
                # candidate gram must END strictly before the current one
                ok &= idx + g - 1 < pos_b
                score = jnp.where(ok, idx, -1)
                i = jnp.max(score)
                start = jnp.clip(i + g, 0, C - n)
                cont = jax.lax.dynamic_slice(hist_b, (start,), (n,))
                # no match: propose the current token n times (acceptance
                # will be whatever the target makes of it)
                return jnp.where(i >= 0, cont, jnp.full(n, cur_b, jnp.int32))

            return jax.vmap(row)(hist, pos, cur)

        two_model = draft is not None

        @partial(jax.jit, donate_argnums=(2, 3), static_argnums=())
        def _run(t_params, d_params, t_cache, d_cache, hist, cur, pos, lens,
                 max_new):
            B = cur.shape[0]
            rows = jnp.arange(B)[:, None]
            span = jnp.arange(n + 1)[None, :]

            def cond(c):
                t_cache, d_cache, hist, cur, pos, rounds, acc = c
                emitted = pos - lens + 1
                return (jnp.min(emitted) < max_new) & \
                       (jnp.max(pos) + n + 1 < C)

            def body(c):
                t_cache, d_cache, hist, cur, pos, rounds, acc = c
                if two_model:
                    d_toks, d_cache = _draft_model(d_params, d_cache, cur, pos)
                else:
                    d_toks = _draft_lookup(hist, cur, pos)
                feed = jnp.concatenate([cur[:, None], d_toks], axis=1)
                positions = pos[:, None] + span
                t_logits, t_cache = t_fwd(t_params, t_cfg, feed, positions,
                                          t_cache, logits_last_only=False)
                t_pred = jnp.argmax(t_logits, axis=-1).astype(jnp.int32)
                if accept_all:
                    k = jnp.full(B, n, jnp.int32)
                else:
                    match = (t_pred[:, :n] == d_toks).astype(jnp.int32)
                    k = jnp.sum(jnp.cumprod(match, axis=1), axis=1)  # [B]
                nxt = jnp.take_along_axis(t_pred, k[:, None], axis=1)[:, 0]
                emit = jnp.where(span < k[:, None],
                                 jnp.pad(d_toks, ((0, 0), (0, 1))), 0)
                emit = emit + jnp.where(span == k[:, None], 1, 0) * nxt[:, None]
                cols = pos[:, None] + 1 + span
                cols = jnp.where(span <= k[:, None], cols, C)  # drop j > k
                hist = hist.at[rows, cols].set(emit, mode="drop")
                return (t_cache, d_cache, hist, nxt, pos + k + 1,
                        rounds + 1, acc + k)

            t_cache, d_cache, hist, cur, pos, rounds, acc = jax.lax.while_loop(
                cond, body,
                (t_cache, d_cache, hist, cur, pos, jnp.int32(0), jnp.zeros(
                    B, jnp.int32)))
            return hist, pos, rounds, acc, t_cache, d_cache

        self._run = _run

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 eos_id: int | None = None):
        """Greedy speculative generation, one device dispatch for the whole
        loop. Returns (tokens per row, stats)."""
        tgt, drf = self.target, self.draft
        B = len(prompts)
        C = tgt.max_seq
        t_cache = tgt.new_cache(B)
        t_logits, t_cache, lens = tgt.prefill(prompts, t_cache)
        if drf is not None:
            d_cache = drf.new_cache(B)
            _, d_cache, _ = drf.prefill(prompts, d_cache)
        else:
            d_cache = jnp.zeros((), jnp.int32)  # dummy carry
        cur = jnp.argmax(t_logits, axis=-1).astype(jnp.int32)
        hist = np.zeros((B, C), np.int32)
        for b, p in enumerate(prompts):
            hist[b, : len(p)] = p
        hist = jnp.asarray(hist)
        lens_d = jnp.asarray(lens, jnp.int32)
        hist = hist.at[jnp.arange(B), lens_d].set(cur)
        d_params = drf.params if drf is not None else jnp.zeros((), jnp.int32)
        hist, pos, rounds, acc, _, _ = self._run(
            tgt.params, d_params, t_cache, d_cache, hist, cur,
            jnp.asarray(lens, jnp.int32), lens_d,
            jnp.int32(max_new_tokens))
        hist_np = np.asarray(hist)
        pos_np = np.asarray(pos)
        out = []
        for b in range(B):
            row = [int(t) for t in
                   hist_np[b, lens[b]: min(lens[b] + max_new_tokens,
                                           pos_np[b] + 1)]]
            if eos_id is not None and eos_id in row:
                row = row[: row.index(eos_id) + 1]
            out.append(row)
        stats = {"rounds": int(rounds), "drafted": int(rounds) * self.n_draft * B,
                 "accepted": int(np.asarray(acc).sum())}
        return out, stats
