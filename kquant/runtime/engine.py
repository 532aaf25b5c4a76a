"""Inference engine: jitted prefill/decode steps around the functional model.

Replaces the reference's context runtime (SURVEY.md 2.1 "Context runtime":
llama_context::decode / process_ubatch / graph_compute at
llama-context.cpp:1088,2747). ggml's per-ubatch graph build + backend
scheduler + threadpool all collapse into two cached XLA executables:

  prefill(tokens [B, T]) — bucketed T (static shapes), right-padded; padded
    slots write garbage K/V beyond each row's length, which is safe because a
    later decode step always overwrites slot p before any query can attend it
    (mask is j <= q_pos).
  decode(tokens [B, 1])  — one token per sequence, cache donated in-place.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from kquant.models.config import ModelConfig
from kquant.models.llama import llama_forward
from kquant.ops.sampling import (
    SamplerConfig,
    greedy,
    init_penalty_state,
    sample,
    sample_step,
)
from kquant.runtime.kv_cache import KVCache

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict[str, Any],
        max_batch: int = 1,
        max_seq: int | None = None,
        kv_quantized: bool = False,
        impl: str = "auto",
        scan_layers: bool = False,
        forward_fn=None,
        mesh=None,
        kv_layout: str = "unified",
        iswa_chunk: int = 512,
    ):
        """scan_layers: stack per-layer params and lax.scan over them — one
        compiled block instead of n_layers inlined copies (compile time and
        HLO size stop growing with depth; the 70B-class configuration).

        forward_fn: drop-in replacement for models.llama.llama_forward (same
        signature), e.g. parallel.pipeline.make_pp_forward(mesh) — params
        must then already be in that forward's expected format.

        kv_layout: 'unified' (every layer gets max_seq slots) or 'iswa'
        (sliding-window layers get a ring of window + chunk slots — the
        llama.cpp llama_kv_cache_unified_iswa equivalent; prompts prefill in
        ring-sized chunks). 'iswa' requires cfg.sliding_window > 0 and the
        unrolled forward."""
        if kv_layout == "iswa":
            if cfg.sliding_window <= 0:
                raise ValueError("kv_layout='iswa' needs a sliding-window arch")
            if scan_layers or forward_fn is not None:
                raise ValueError("kv_layout='iswa' requires the default "
                                 "unrolled forward")
        if cfg.is_recurrent:
            # mamba: the memory context is a recurrent state, not a KV ring
            # (llama.cpp's recurrent llama_memory_context_i backend)
            if kv_layout != "unified" or kv_quantized or scan_layers:
                raise ValueError("recurrent archs use the default unified "
                                 "layout, fp state, unrolled forward")
            if forward_fn is None:
                from kquant.models.mamba import mamba_forward

                forward_fn = mamba_forward
        self.kv_layout = kv_layout
        self.iswa_chunk = iswa_chunk
        if scan_layers:
            from kquant.models.llama import stack_layer_params

            params = stack_layer_params(params)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq or cfg.max_seq_len
        self.kv_quantized = kv_quantized
        self.impl = impl

        is_llama_fwd = forward_fn is None  # default llama_forward only
        fwd = partial(forward_fn or llama_forward, impl=impl)
        if mesh is not None:  # needed only by the MoE a2a dispatch
            fwd = partial(fwd, mesh=mesh)
        self._fwd = fwd  # raw traced forward (runtime.speculative fuses it
        #                  into its own device-resident round loop)

        @partial(jax.jit, donate_argnums=(3,), static_argnums=(4,))
        def _step(params, tokens, positions, cache, last_only):
            # NOTE: no kv_attend_len here — _step also serves callers whose
            # T > 1 queries sit mid-sequence (speculative verify windows,
            # perplexity over a pre-filled cache); only _step_prefill below
            # may assume positions = arange(T)
            return fwd(params, cfg, tokens, positions, cache,
                       logits_last_only=last_only)

        @partial(jax.jit, donate_argnums=(3,))
        def _step_prefill(params, tokens, positions, cache):
            """Bucketed prefill only (positions = arange(T)): attention
            skips the cache tail beyond slot T (masked anyway; ~27% of
            pp512 attention at the bench's 704-slot cache)."""
            kw = {}
            if is_llama_fwd and tokens.shape[1] > 1:
                kw["kv_attend_len"] = tokens.shape[1]
            return fwd(params, cfg, tokens, positions, cache,
                       logits_last_only=False, **kw)

        self._step_prefill = _step_prefill

        self._step = _step

        @partial(jax.jit, donate_argnums=(3,))
        def _step_valid(params, tokens, positions, cache, kv_valid):
            """iSWA prefill step: pad slots must not be written to the rings.
            Also the serving admission-burst forward (unified layout), where
            positions are arange(T) per row — the live-prefix attention
            bound applies there but NOT to chunked iSWA prefill (later
            chunks query positions >= T)."""
            kw = {}
            if (is_llama_fwd and kv_layout == "unified"
                    and tokens.shape[1] > 1):
                kw["kv_attend_len"] = tokens.shape[1]
            return fwd(params, cfg, tokens, positions, cache,
                       logits_last_only=False, kv_valid=kv_valid, **kw)

        self._step_valid = _step_valid

        @partial(jax.jit, donate_argnums=(3,), static_argnums=(4,))
        def _decode_loop(params, first_tok, start_pos, cache, n_steps):
            """n_steps greedy decode steps fused into ONE executable
            (lax.scan): no host round-trip per token — the on-device
            replacement for llama-bench's per-token llama_decode loop."""

            def body(carry, _):
                tok, pos, cache = carry
                logits, cache = fwd(
                    params, cfg, tok[:, None], pos[:, None], cache,
                    logits_last_only=True,
                )
                ntok = jnp.argmax(logits[:, 0, :], axis=-1).astype(jnp.int32)
                return (ntok, pos + 1, cache), ntok

            (tok, pos, cache), toks = jax.lax.scan(
                body, (first_tok, start_pos, cache), length=n_steps
            )
            return toks.T, cache  # [B, n_steps]

        self._decode_loop = _decode_loop

        @partial(jax.jit, donate_argnums=(3,), static_argnums=(4, 5))
        def _decode_loop_sampled(params, first_tok, start_pos, cache, n_steps,
                                 sc: SamplerConfig, key, penalty_state):
            """The fused decode loop with the FULL sampler chain on-device
            (temp/top-k/top-p/min-p + repeat/presence/frequency penalties over
            a sliding last-n window): non-greedy generation stops paying a
            host round-trip per token. sc is static — one executable per
            sampler configuration."""

            def body(carry, _):
                tok, pos, cache, key, pstate = carry
                logits, cache = fwd(
                    params, cfg, tok[:, None], pos[:, None], cache,
                    logits_last_only=True,
                )
                ntok, key, pstate = sample_step(logits[:, 0, :], key, sc, pstate)
                return (ntok, pos + 1, cache, key, pstate), ntok

            (tok, pos, cache, key, pstate), toks = jax.lax.scan(
                body, (first_tok, start_pos, cache, key, penalty_state),
                length=n_steps,
            )
            return toks.T, cache, key, pstate  # toks [B, n_steps]

        self._decode_loop_sampled = _decode_loop_sampled

        @partial(jax.jit, static_argnums=(2,))
        def _sample_first(logits, key, sc: SamplerConfig, penalty_state):
            return sample_step(logits, key, sc, penalty_state)

        self._sample_first = _sample_first

        from kquant.runtime.kv_cache import set_batch_row, slice_batch_row

        @partial(jax.jit, donate_argnums=(3,))
        def _prefill_slot(params, tokens, positions, cache, slot, kv_valid):
            """Prefill ONE sequence into batch row ``slot`` (traced index)
            while other rows' cache stays intact — the primitive behind
            continuous batching (requests join a running batch). kv_valid
            masks right-pad steps — required for recurrent state (a pad
            update is forever), ignored by unified-KV appends (pad slots
            are overwritten before they can be attended)."""
            kw = {}
            if (is_llama_fwd and kv_layout == "unified"
                    and tokens.shape[1] > 1):
                # a slot prefill's positions are arange(T) (fresh request)
                kw["kv_attend_len"] = tokens.shape[1]
            row = slice_batch_row(cache, slot)
            if cfg.is_recurrent:
                # a reused slot's row still holds the PREVIOUS request's
                # final conv/ssm state (plus any dummy-decode drift while the
                # slot sat inactive); a recurrent forward carries the
                # incoming row as its initial state, so it must start from
                # zeros — a KV row needs no reset (pads are overwritten)
                row = jax.tree.map(jnp.zeros_like, row)
            logits, row = fwd(
                params, cfg, tokens, positions, row, logits_last_only=False,
                kv_valid=kv_valid, **kw,
            )
            return logits[0], set_batch_row(cache, row, slot)

        self._prefill_slot = _prefill_slot

        from kquant.runtime.kv_cache import shift_cache

        @partial(jax.jit, donate_argnums=(0,), static_argnums=(1, 2))
        def _shift(cache, n_keep, n_discard):
            return shift_cache(cache, n_keep, n_discard, cfg.rope)

        self._shift = _shift

    def new_cache(self, batch: int | None = None) -> KVCache:
        if self.cfg.is_recurrent:
            from kquant.models.mamba import RecurrentCache

            return RecurrentCache.create(
                self.cfg.n_layers, batch or self.max_batch,
                self.cfg.ssm_d_conv, self.cfg.ssm_d_inner,
                self.cfg.ssm_d_state,
            )
        if self.kv_layout == "iswa":
            from kquant.runtime.kv_cache import ISWACache

            W = self.cfg.sliding_window
            # ring = window + a prefill chunk, like llama.cpp's n_swa+n_ubatch
            ring = min(self.max_seq, -(-(W + self.iswa_chunk) // 16) * 16)
            windows = [self.cfg.layer_window(i)
                       for i in range(self.cfg.n_layers)]
            return ISWACache.create(
                windows, batch or self.max_batch, self.max_seq, ring,
                self.cfg.n_kv_heads, self.cfg.head_dim,
                quantized=self.kv_quantized,
            )
        return KVCache.create(
            self.cfg.n_layers,
            batch or self.max_batch,
            self.max_seq,
            self.cfg.n_kv_heads,
            self.cfg.head_dim,
            quantized=self.kv_quantized,
        )

    # -- steps -----------------------------------------------------------------
    def prefill(self, token_rows: list[list[int]], cache: KVCache):
        """Right-padded bucketed prefill. Returns (last_logits [B, V], cache,
        lengths [B])."""
        B = len(token_rows)
        lens = np.array([len(t) for t in token_rows], np.int32)
        if int(lens.max()) > self.max_seq:
            raise ValueError(
                f"prompt length {int(lens.max())} exceeds max_seq {self.max_seq}"
            )
        if self.kv_layout == "iswa":
            return self._prefill_iswa(token_rows, cache, lens)
        T = min(_bucket(int(lens.max())), self.max_seq)
        toks = np.zeros((B, T), np.int32)
        for i, row in enumerate(token_rows):
            toks[i, : len(row)] = row
        positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
        if self.cfg.is_recurrent:
            # pad steps must NOT touch the recurrent state (a KV pad slot is
            # overwritten later; a recurrent state update is forever)
            valid = positions < lens[:, None]
            logits, cache = self._step_valid(
                self.params, jnp.asarray(toks), jnp.asarray(positions), cache,
                jnp.asarray(valid),
            )
            last = jnp.take_along_axis(
                logits, jnp.asarray(lens - 1)[:, None, None], axis=1)
            return last[:, 0, :], cache, lens
        logits, cache = self._step_prefill(
            self.params, jnp.asarray(toks), jnp.asarray(positions), cache
        )
        last = jnp.take_along_axis(logits, jnp.asarray(lens - 1)[:, None, None], axis=1)
        return last[:, 0, :], cache, lens

    def _prefill_iswa(self, token_rows: list[list[int]], cache, lens):
        """Chunked prefill for the iSWA ring layout: each chunk is at most
        ring - window tokens, so (a) every query still finds its full window
        in the ring and (b) a chunk's pad positions can never wrap onto live
        history (kv_cache.ISWACache.append masks them out with kv_valid)."""
        B = len(token_rows)
        W = self.cfg.sliding_window
        budget = cache.ring - W
        if budget < PREFILL_BUCKETS[0]:
            raise ValueError(f"iswa ring {cache.ring} too small for window {W}")
        C = max(b for b in PREFILL_BUCKETS if b <= budget)
        maxlen = int(lens.max())
        last = [None] * B
        for c0 in range(0, maxlen, C):
            T = min(_bucket(min(C, maxlen - c0)), C)
            toks = np.zeros((B, T), np.int32)
            for i, row in enumerate(token_rows):
                seg = row[c0 : c0 + T]
                toks[i, : len(seg)] = seg
            positions = np.broadcast_to(
                c0 + np.arange(T, dtype=np.int32), (B, T)
            ).astype(np.int32)
            valid = positions < lens[:, None]
            logits, cache = self._step_valid(
                self.params, jnp.asarray(toks), jnp.asarray(positions), cache,
                jnp.asarray(valid),
            )
            for i in range(B):
                e = int(lens[i]) - 1
                if c0 <= e < c0 + T:
                    last[i] = logits[i, e - c0, :]
        return jnp.stack(last), cache, lens

    def decode_step(self, tokens: jnp.ndarray, positions: jnp.ndarray, cache: KVCache):
        """tokens [B], positions [B] -> (logits [B, V], cache)."""
        logits, cache = self._step(
            self.params, tokens[:, None], positions[:, None], cache, True
        )
        return logits[:, 0, :], cache

    def prefill_slot(self, tokens: list[int], cache: KVCache, slot: int):
        """Prefill one request into batch row ``slot``. Returns (last_logits
        [V], cache)."""
        if self.kv_layout != "unified":
            raise NotImplementedError("slot prefill requires the unified KV layout")
        if len(tokens) > self.max_seq:
            raise ValueError(f"prompt length {len(tokens)} exceeds max_seq {self.max_seq}")
        T = min(_bucket(len(tokens)), self.max_seq)
        toks = np.zeros((1, T), np.int32)
        toks[0, : len(tokens)] = tokens
        positions = np.arange(T, dtype=np.int32)[None, :]
        valid = (positions < len(tokens))
        logits, cache = self._prefill_slot(
            self.params, jnp.asarray(toks), jnp.asarray(positions), cache,
            jnp.int32(slot), jnp.asarray(valid),
        )
        return logits[len(tokens) - 1], cache

    def decode_greedy_jit(self, first_tok: jnp.ndarray, start_pos: jnp.ndarray,
                          cache: KVCache, n_steps: int):
        """[B] first tokens -> ([B, n_steps] greedy tokens, cache); fully
        on-device (single dispatch)."""
        return self._decode_loop(self.params, first_tok, start_pos, cache, n_steps)

    def decode_sampled_jit(self, first_tok: jnp.ndarray, start_pos: jnp.ndarray,
                           cache: KVCache, n_steps: int, sc: SamplerConfig,
                           key, penalty_state=None):
        """Fused sampled decode: [B] first tokens -> ([B, n_steps] tokens,
        cache, key, penalty_state); the full sampler chain runs inside the
        on-device lax.scan (single dispatch, like decode_greedy_jit)."""
        return self._decode_loop_sampled(
            self.params, first_tok, start_pos, cache, n_steps, sc, key,
            penalty_state,
        )

    def shift_context(self, cache: KVCache, positions, n_keep: int, n_discard: int):
        """Discard positions [n_keep, n_keep + n_discard) from every row and
        slide the tail down (K re-rotated in place). Returns (cache,
        new_positions). Every row must have at least n_keep + n_discard live
        entries, or it would lose tokens it still attends to."""
        if self.kv_layout != "unified" or self.cfg.is_recurrent:
            raise NotImplementedError("context shift requires the unified KV layout")
        positions = np.asarray(positions)
        if int(positions.min()) < n_keep + n_discard:
            raise ValueError(
                f"shift of {n_discard} after keep={n_keep} would drop live "
                f"entries of a row at position {int(positions.min())}"
            )
        cache = self._shift(cache, int(n_keep), int(n_discard))
        return cache, jnp.asarray(positions - n_discard, jnp.int32)

    # -- session persistence ---------------------------------------------------
    def save_session(self, path: str, cache: KVCache, lengths) -> None:
        """Serialize a KV cache + per-row lengths (the llama.cpp session-file
        equivalent: resume generation without re-prefilling).

        bf16 arrays are stored as uint16 bit patterns (npz has no bf16)."""
        if self.kv_layout != "unified":
            raise NotImplementedError("sessions require the unified KV layout")
        import numpy as np

        if self.cfg.is_recurrent:
            # recurrent session = the (conv, ssm) state arrays; O(1) in
            # context length, unlike a KV session
            np.savez(path, lengths=np.asarray(lengths, np.int32),
                     conv=np.asarray(cache.conv), ssm=np.asarray(cache.ssm),
                     recurrent=np.int32(1))
            return

        def enc(x):
            a = np.asarray(x)
            if a.dtype.itemsize == 2 and a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
                return a.view(np.uint16)
            return a

        arrs = {"lengths": np.asarray(lengths, np.int32),
                "k": enc(cache.k), "v": enc(cache.v),
                "kv_dtype": np.frombuffer(str(cache.k.dtype).encode(), np.uint8)}
        if cache.quantized:
            arrs["k_scale"] = np.asarray(cache.k_scale)
            arrs["v_scale"] = np.asarray(cache.v_scale)
        np.savez(path, **arrs)

    def load_session(self, path: str):
        """Returns (cache, lengths)."""
        import numpy as np

        z = np.load(path)
        if "recurrent" in z:
            from kquant.models.mamba import RecurrentCache

            return (RecurrentCache(conv=jnp.asarray(z["conv"]),
                                   ssm=jnp.asarray(z["ssm"])),
                    z["lengths"])
        dt = jnp.dtype(bytes(z["kv_dtype"]).decode())

        def dec(a):
            if a.dtype == np.uint16 and dt == jnp.bfloat16:
                return jnp.asarray(a).view(jnp.bfloat16)
            return jnp.asarray(a)

        cache = KVCache(
            k=dec(z["k"]),
            v=dec(z["v"]),
            k_scale=jnp.asarray(z["k_scale"]) if "k_scale" in z else None,
            v_scale=jnp.asarray(z["v_scale"]) if "v_scale" in z else None,
        )
        return cache, z["lengths"]

    # -- generation loop -------------------------------------------------------
    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: int | None = None,
        seed: int = 0,
        context_shift: bool = False,
        n_keep: int = 0,
        min_p: float = 0.0,
        repeat_penalty: float = 1.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        penalty_last_n: int = 64,
    ) -> list[list[int]]:
        """Greedy/sampled generation; returns newly generated ids per row.

        context_shift: when the KV cache fills, discard half of the
        (max_seq - n_keep) oldest evictable positions and keep generating —
        llama.cpp main's --keep/context-shift behavior. Without it,
        generation is clamped to the KV capacity.

        repeat/presence/frequency penalties follow llama.cpp's penalties
        sampler over the last penalty_last_n context tokens.

        Without context_shift the whole generation (sampler chain included)
        runs as ONE fused on-device lax.scan — no host round-trip per token;
        eos truncation happens on host afterwards. The host-stepped loop
        remains only for context_shift (a host-decided cache mutation)."""
        sc = SamplerConfig(
            temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
            repeat_penalty=repeat_penalty, presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty, penalty_last_n=penalty_last_n,
        )
        B = len(prompts)
        cache = self.new_cache(B)
        logits, cache, lens = self.prefill(prompts, cache)
        key = jax.random.PRNGKey(seed)
        positions = jnp.asarray(lens)  # next position per row
        pstate = (
            init_penalty_state(prompts, self.cfg.vocab_size, sc.penalty_last_n)
            if sc.uses_penalties else None
        )
        if not context_shift:
            # never decode past the KV capacity (slot p must exist to be written)
            max_new_tokens = min(max_new_tokens, self.max_seq - int(lens.max()))
            if max_new_tokens <= 0:
                return [[] for _ in range(B)]
            tok, key, pstate = self._sample_first(logits, key, sc, pstate)
            if max_new_tokens > 1:
                rest, cache, key, pstate = self.decode_sampled_jit(
                    tok, positions, cache, max_new_tokens - 1, sc, key, pstate
                )
                toks = np.concatenate(
                    [np.asarray(tok)[:, None], np.asarray(rest)], axis=1
                )
            else:
                toks = np.asarray(tok)[:, None]
            out = []
            for i in range(B):
                row = [int(t) for t in toks[i]]
                if eos_id is not None and eos_id in row:
                    row = row[: row.index(eos_id) + 1]
                out.append(row)
            return out

        out: list[list[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        tok = None
        for step in range(max_new_tokens):
            if step > 0:
                if int(jnp.max(positions)) >= self.max_seq:
                    n_discard = max(1, (self.max_seq - n_keep) // 2)
                    cache, positions = self.shift_context(
                        cache, positions, n_keep, n_discard
                    )
                logits, cache = self.decode_step(tok, positions, cache)
                positions = positions + 1
            tok, key, pstate = self._sample_first(
                jnp.asarray(logits), key, sc, pstate
            )
            tok_np = np.asarray(tok)
            for i in range(B):
                if not done[i]:
                    out[i].append(int(tok_np[i]))
                    if eos_id is not None and tok_np[i] == eos_id:
                        done[i] = True
            if done.all():
                break
        return out
