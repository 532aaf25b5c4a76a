#!/usr/bin/env python
"""Train a small llama-architecture model IN-ENVIRONMENT so the perplexity-Δ
quality gate can be measured on genuinely-learned weights (VERDICT r1 item 3:
the repo had a ppl-Δ harness but no measured number; zero egress means no
real checkpoints, and a random-weight model's ppl is flat ~vocab_size so its
quantization delta is meaningless).

Design: the training forward IS the inference forward — models.llama.
llama_forward over dense-QTensor params is differentiable jnp end-to-end, so
the exported GGUF is semantically identical to what the engine computes (a
logit-parity assert at the end proves it). Data is a deterministic synthetic
grammar (subject/verb/object agreement, spelled-out arithmetic, templated
clauses) with a held-out split for the ppl corpus; the tokenizer is a
byte-level BPE trained on the corpus with the llama-3 pre-tokenizer and
exported as standard GGUF gpt2-tokenizer metadata.

Outputs (under .cache/):
  trained-tiny-f16.gguf   — the f16 base model
  ppl_holdout.txt         — held-out text for tools/ppl_delta.py

Usage: python tools_train_tiny.py [--steps 2500] [--cpu]
Then:  python -m kquant.tools.ppl_delta --model .cache/trained-tiny-f16.gguf \\
           --text .cache/ppl_holdout.txt --type q4_k_m --ctx 256
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# synthetic corpus: deterministic grammar with learnable structure
# ---------------------------------------------------------------------------

SUBJECTS = ["the cat", "the dog", "a bird", "the old man", "my sister",
            "the tall woman", "a small child", "the engineer", "the teacher",
            "a young fox", "the river", "the machine"]
VERBS_S = ["runs", "jumps", "sleeps", "sings", "watches", "builds", "finds",
           "follows", "carries", "paints"]
VERBS_P = ["run", "jump", "sleep", "sing", "watch", "build", "find",
           "follow", "carry", "paint"]
OBJECTS = ["over the fence", "near the house", "in the garden",
           "across the road", "under the bridge", "through the forest",
           "behind the wall", "beside the lake", "with great care",
           "every single day"]
NUMS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
        "eight", "nine"]
ADJ = ["quick", "lazy", "bright", "quiet", "heavy", "gentle"]


def gen_corpus(n_sentences: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sentences):
        kind = rng.integers(0, 4)
        if kind == 0:  # simple SVO
            s = rng.choice(SUBJECTS)
            v = rng.choice(VERBS_S)
            o = rng.choice(OBJECTS)
            out.append(f"{s} {v} {o} .")
        elif kind == 1:  # conjunction, plural agreement (learnable rule)
            s1, s2 = rng.choice(SUBJECTS, 2, replace=False)
            v = rng.choice(VERBS_P)
            o = rng.choice(OBJECTS)
            out.append(f"{s1} and {s2} {v} {o} .")
        elif kind == 2:  # arithmetic fact (hard structure)
            a, b = int(rng.integers(0, 5)), int(rng.integers(0, 5))
            out.append(f"{NUMS[a]} plus {NUMS[b]} is {NUMS[a + b]} .")
        else:  # adjective template
            s = rng.choice(SUBJECTS)
            adj = rng.choice(ADJ)
            v = rng.choice(VERBS_S)
            out.append(f"{s} is {adj} and {v} {rng.choice(OBJECTS)} .")
    return out


# ---------------------------------------------------------------------------
# tokenizer: byte-level BPE trained on the corpus (llama-3 pre-tokenizer),
# exported as GGUF gpt2-tokenizer metadata
# ---------------------------------------------------------------------------


def train_bpe(corpus: list[str], vocab_size: int):
    import json

    import tokenizers
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    from kquant.tokenizer.bpe import PRE_PATTERNS, BPETokenizer

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(tokenizers.Regex(PRE_PATTERNS["llama3"]),
                             behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<s>", "</s>"],
        show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(corpus, trainer)
    blob = json.loads(tok.to_str())
    vocab, merges = blob["model"]["vocab"], blob["model"]["merges"]
    tokens = [None] * len(vocab)
    for piece, i in vocab.items():
        tokens[i] = piece
    # pad to exactly vocab_size (training may converge short)
    while len(tokens) < vocab_size:
        tokens.append(f"<pad{len(tokens)}>")
    merge_strs = [m if isinstance(m, str) else f"{m[0]} {m[1]}" for m in merges]
    ours = BPETokenizer(tokens, merge_strs, bos_id=0, eos_id=1,
                        special_ids={0, 1}, pre="llama3")
    return ours, tokens, merge_strs


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sentences", type=int, default=60000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=str(REPO / ".cache" / "trained-tiny-f16.gguf"))
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from kquant.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import optax

    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.models.llama import llama_forward
    from kquant.runtime import load_model
    from kquant.runtime.kv_cache import KVCache

    log(f"devices: {jax.devices()}")
    V = 512
    cfg0 = tiny_config(n_layers=4, dim=256, n_heads=8, n_kv_heads=4,
                       ffn_dim=768, vocab_size=V, max_seq_len=512)

    # -- corpus + tokenizer ---------------------------------------------------
    sents = gen_corpus(args.sentences, seed=0)
    n_hold = max(200, len(sents) // 20)
    train_sents, hold_sents = sents[:-n_hold], sents[-n_hold:]
    tok, tokens, merges = train_bpe(train_sents, V)
    ids = []
    for s in train_sents:
        ids.extend(tok.encode(s + "\n", add_bos=False))
    data = np.asarray(ids, np.int32)
    log(f"corpus: {len(train_sents)} sentences -> {data.size} tokens "
        f"({len(hold_sents)} held out)")

    # -- init params from a loaded f16 fixture (exact loader pytree) ----------
    with tempfile.TemporaryDirectory() as td:
        tmp = str(Path(td) / "init.gguf")
        write_fixture_gguf(tmp, cfg0, seed=1, quant="f16", scale=0.02)
        cfg, params, reader = load_model(tmp, fuse=False)
        reader.close()
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float32), params
    )
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    log(f"model: L={cfg.n_layers} dim={cfg.dim} V={V}  {n_params/1e6:.1f}M params")

    B, T = args.batch, args.seq
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))

    def loss_fn(p, batch):
        cache = KVCache.create(L, B, T, Hkv, hd, dtype=jnp.float32)
        logits, _ = llama_forward(p, cfg, batch, positions, cache,
                                  impl="xla", act_dtype=jnp.float32)
        lp = jax.nn.log_softmax(logits[:, :-1, :], axis=-1)
        tgt = batch[:, 1:]
        nll = -jnp.take_along_axis(lp, tgt[..., None], axis=-1)[..., 0]
        return nll.mean()

    sched = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(100, args.steps // 5),
        decay_steps=args.steps, end_value=args.lr * 0.05,
    )
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))
    opt_state = opt.init(params)
    data_dev = jnp.asarray(data)

    K = 25  # steps per dispatch (one jitted scan of K steps)

    @jax.jit
    def train_k(params, opt_state, key):
        def step(carry, k):
            params, opt_state = carry
            starts = jax.random.randint(k, (B,), 0, data_dev.size - T - 1)
            batch = jax.vmap(
                lambda s: jax.lax.dynamic_slice(data_dev, (s,), (T,))
            )(starts)
            loss, grads = jax.value_and_grad(loss_fn)(params, batch)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        keys = jax.random.split(key, K)
        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), keys
        )
        return params, opt_state, losses.mean(), losses[-1]

    key = jax.random.PRNGKey(0)
    t0 = time.time()
    for it in range(args.steps // K):
        key, sub = jax.random.split(key)
        params, opt_state, mean_loss, last_loss = train_k(params, opt_state, sub)
        if it % 10 == 0 or it == args.steps // K - 1:
            log(f"step {K * (it + 1):5d}/{args.steps}  loss {float(mean_loss):.4f} "
                f"(ppl {np.exp(float(mean_loss)):.2f})  {time.time() - t0:.0f}s")

    # -- export f16 GGUF (inverse rope permutation; loader re-canonicalizes) --
    from kquant.gguf import GGUFWriter
    from kquant.gguf.constants import GGMLType
    from kquant.runtime.loader import _rope_neox_perm

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    w = GGUFWriter(str(out_path))
    for k, v in cfg0.to_gguf_metadata().items():
        w.add(k, v)
    w.add("general.name", "trained-tiny")
    w.add("tokenizer.ggml.model", "gpt2")
    w.add("tokenizer.ggml.pre", "llama3")
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.merges", merges)
    w.add("tokenizer.ggml.token_type",
          np.array([3, 3] + [1] * (V - 2), np.int32))
    w.add("tokenizer.ggml.bos_token_id", 0)
    w.add("tokenizer.ggml.eos_token_id", 1)

    q_inv = np.argsort(_rope_neox_perm(cfg.n_heads * hd, hd))
    k_inv = np.argsort(_rope_neox_perm(Hkv * hd, hd))

    def wnp(qt):
        return np.asarray(qt.arrays["w"], np.float32)

    def add_t(name, arr, ftype=GGMLType.F16):
        w.add_tensor(name, np.ascontiguousarray(arr), ftype)

    add_t("token_embd.weight", wnp(params["tok_embd"]))
    add_t("output_norm.weight", wnp(params["output_norm"]), GGMLType.F32)
    add_t("output.weight", wnp(params["output"]))
    for i, lyr in enumerate(params["layers"]):
        p = f"blk.{i}."
        add_t(p + "attn_norm.weight", wnp(lyr["attn_norm"]), GGMLType.F32)
        add_t(p + "attn_q.weight", wnp(lyr["wq"])[q_inv])
        add_t(p + "attn_k.weight", wnp(lyr["wk"])[k_inv])
        add_t(p + "attn_v.weight", wnp(lyr["wv"]))
        add_t(p + "attn_output.weight", wnp(lyr["wo"]))
        add_t(p + "ffn_norm.weight", wnp(lyr["ffn_norm"]), GGMLType.F32)
        add_t(p + "ffn_gate.weight", wnp(lyr["w_gate"]))
        add_t(p + "ffn_up.weight", wnp(lyr["w_up"]))
        add_t(p + "ffn_down.weight", wnp(lyr["w_down"]))
    w.write()
    log(f"wrote {out_path}")

    hold_path = out_path.parent / "ppl_holdout.txt"
    hold_path.write_text("\n".join(hold_sents) + "\n", encoding="utf-8")
    log(f"wrote {hold_path}")

    # -- parity: engine on exported GGUF must match the training forward ------
    from kquant.runtime import InferenceEngine

    cfg2, params2, r2 = load_model(str(out_path), fuse=False)
    eng = InferenceEngine(cfg2, params2, max_batch=1, max_seq=64, impl="xla")
    probe = tok.encode("the cat runs over the fence .", add_bos=False)[:16]
    lg_eng, _, _ = eng.prefill([probe], eng.new_cache(1))
    cache = KVCache.create(L, 1, len(probe), Hkv, hd, dtype=jnp.float32)
    lg_train, _ = llama_forward(
        params, cfg, jnp.asarray([probe], jnp.int32),
        jnp.arange(len(probe), dtype=jnp.int32)[None, :], cache,
        impl="xla", act_dtype=jnp.float32,
    )
    a = np.asarray(lg_eng[0], np.float32)
    b = np.asarray(lg_train[0, -1], np.float32)
    corr = float(np.corrcoef(a, b)[0, 1])
    log(f"parity: engine-vs-training logit corr {corr:.5f}, "
        f"argmax {'MATCH' if a.argmax() == b.argmax() else 'MISMATCH'}")
    assert corr > 0.995, "exported GGUF does not reproduce the trained model"
    r2.close()


if __name__ == "__main__":
    main()
