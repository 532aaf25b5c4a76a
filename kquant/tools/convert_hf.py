"""HF checkpoint -> GGUF converter (convert_hf_to_gguf equivalent).

Produces GGUF files interoperable with the wider ecosystem: q/k projection
rows are permuted from HF's split-half rotary layout into Meta layout
(llama.cpp's convert-time ``permute``) so the file decodes correctly under
ggml-NORM rope — the same convention our engine applies for llama-family
arches (ops/rope.py).

  python -m kquant.tools.convert_hf --hf /path/to/hf_dir --out m.gguf \
      --type f16|q4_k_m|q8_0|...
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from kquant.gguf import GGMLType, GGUFWriter

_NAME_MAP = [
    ("model.embed_tokens.weight", "token_embd.weight"),
    ("model.norm.weight", "output_norm.weight"),
    ("lm_head.weight", "output.weight"),
]
_LAYER_MAP = [
    ("input_layernorm.weight", "attn_norm.weight"),
    ("self_attn.q_proj.weight", "attn_q.weight"),
    ("self_attn.k_proj.weight", "attn_k.weight"),
    ("self_attn.v_proj.weight", "attn_v.weight"),
    ("self_attn.o_proj.weight", "attn_output.weight"),
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
    ("mlp.gate_proj.weight", "ffn_gate.weight"),
    ("mlp.up_proj.weight", "ffn_up.weight"),
    ("mlp.down_proj.weight", "ffn_down.weight"),
    ("self_attn.q_proj.bias", "attn_q.bias"),
    ("self_attn.k_proj.bias", "attn_k.bias"),
    ("self_attn.v_proj.bias", "attn_v.bias"),
]


def permute_qk(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF split-half rotary layout -> Meta adjacent-pair layout
    (llama.cpp convert_hf_to_gguf permute)."""
    shape = w.shape
    return (
        w.reshape(n_head, 2, shape[0] // n_head // 2, *shape[1:])
        .swapaxes(1, 2)
        .reshape(shape)
    )


def _target_type(name: str, shape, recipe: str) -> GGMLType:
    from kquant.tools.quantize import _target_type as tt

    return tt(name, shape, recipe)


def convert(hf_dir: str, out_path: str, recipe: str = "f16",
            arch: str = "llama", verbose: bool = True) -> str:
    hf_dir = str(hf_dir)
    cfg = json.loads((Path(hf_dir) / "config.json").read_text())
    state = _load_state_dict(hf_dir)
    if cfg.get("model_type") == "mamba":
        return _convert_mamba(hf_dir, out_path, cfg, state, recipe, verbose)

    n_layers = cfg["num_hidden_layers"]
    n_head = cfg["num_attention_heads"]
    n_kv = cfg.get("num_key_value_heads", n_head)
    dim = cfg["hidden_size"]
    head_dim = cfg.get("head_dim", dim // n_head)

    w = GGUFWriter(out_path)
    w.add("general.architecture", arch)
    w.add("general.name", Path(hf_dir).name)
    w.add(f"{arch}.block_count", n_layers)
    w.add(f"{arch}.context_length", cfg.get("max_position_embeddings", 4096))
    w.add(f"{arch}.embedding_length", dim)
    w.add(f"{arch}.feed_forward_length", cfg["intermediate_size"])
    w.add(f"{arch}.attention.head_count", n_head)
    w.add(f"{arch}.attention.head_count_kv", n_kv)
    w.add(f"{arch}.attention.key_length", head_dim)
    w.add(f"{arch}.attention.layer_norm_rms_epsilon", float(cfg.get("rms_norm_eps", 1e-5)))
    w.add(f"{arch}.rope.freq_base", float(cfg.get("rope_theta", 10000.0)))
    w.add(f"{arch}.rope.dimension_count", head_dim)
    w.add(f"{arch}.vocab_size", cfg["vocab_size"])

    def put(gguf_name: str, arr: np.ndarray):
        t = _target_type(gguf_name, arr.shape, recipe)
        w.add_tensor(gguf_name, arr.astype(np.float32), t)
        if verbose:
            print(f"  {gguf_name}: {tuple(arr.shape)} -> {t.name}", file=sys.stderr)

    consumed = set()
    for hf_name, gguf_name in _NAME_MAP:
        if hf_name in state:
            put(gguf_name, state[hf_name])
            consumed.add(hf_name)
    if "lm_head.weight" not in state and cfg.get("tie_word_embeddings", False):
        pass  # loader falls back to tied embeddings

    for i in range(n_layers):
        for hf_suffix, gguf_suffix in _LAYER_MAP:
            hf_name = f"model.layers.{i}.{hf_suffix}"
            if hf_name not in state:
                continue
            arr = state[hf_name]
            if arch in ("llama", "mistral") and hf_suffix.endswith(("q_proj.weight", "q_proj.bias")):
                arr = permute_qk(arr, n_head)
            elif arch in ("llama", "mistral") and hf_suffix.endswith(("k_proj.weight", "k_proj.bias")):
                arr = permute_qk(arr, n_kv)
            put(f"blk.{i}.{gguf_suffix}", arr)
            consumed.add(hf_name)

    leftovers = [k for k in state if k not in consumed and "rotary_emb" not in k]
    if leftovers and verbose:
        print(f"  WARNING: unconverted tensors: {leftovers[:8]}", file=sys.stderr)
    _export_tokenizer(w, hf_dir, cfg, verbose=verbose)
    w.write()
    return out_path


def _export_tokenizer(w: GGUFWriter, hf_dir: str, cfg: dict,
                      verbose: bool = True) -> bool:
    """Export the HF fast-tokenizer (tokenizer.json) as GGUF tokenizer
    metadata so the converted model is a *complete* artifact (llama.cpp's
    convert_hf_to_gguf embeds the vocab the same way; reference SURVEY.md
    2.1 'Vocab / tokenizer'). Supports byte-level BPE (-> gpt2 model +
    merges) and Unigram (-> llama/spm pieces + scores)."""
    tj = Path(hf_dir) / "tokenizer.json"
    if not tj.exists():
        if verbose:
            print("  (no tokenizer.json — tokenizer not embedded)", file=sys.stderr)
        return False
    blob = json.loads(tj.read_text(encoding="utf-8"))
    model = blob.get("model", {})
    added = blob.get("added_tokens", [])
    special_ids = {int(t["id"]) for t in added if t.get("special")}

    def _token_types(n: int, byte_ids=()) -> np.ndarray:
        tt = np.ones(n, np.int32)  # NORMAL
        for i in byte_ids:
            tt[i] = 6  # BYTE
        for i in special_ids:
            if i < n:
                tt[i] = 3  # CONTROL
        return tt

    bos = cfg.get("bos_token_id")
    eos = cfg.get("eos_token_id")

    if model.get("type") == "BPE":
        vocab, merges = model["vocab"], model["merges"]
        tokens = [""] * (max(vocab.values()) + 1)
        for piece, i in vocab.items():
            tokens[i] = piece
        for t in added:  # added specials may sit past the base vocab
            i = int(t["id"])
            if i >= len(tokens):
                tokens.extend([""] * (i + 1 - len(tokens)))
            tokens[i] = t["content"]
        merge_strs = [m if isinstance(m, str) else f"{m[0]} {m[1]}" for m in merges]
        w.add("tokenizer.ggml.model", "gpt2")
        w.add("tokenizer.ggml.pre", _detect_pre(blob))
        w.add("tokenizer.ggml.tokens", tokens)
        w.add("tokenizer.ggml.merges", merge_strs)
        w.add("tokenizer.ggml.token_type", _token_types(len(tokens)))
    elif model.get("type") == "Unigram":
        pieces = model["vocab"]  # [[piece, logprob], ...]
        tokens = [p[0] for p in pieces]
        scores = np.asarray([p[1] for p in pieces], np.float32)
        byte_ids = [i for i, t in enumerate(tokens)
                    if len(t) == 6 and t.startswith("<0x") and t.endswith(">")]
        w.add("tokenizer.ggml.model", "llama")
        w.add("tokenizer.ggml.tokens", tokens)
        w.add("tokenizer.ggml.scores", scores)
        w.add("tokenizer.ggml.token_type", _token_types(len(tokens), byte_ids))
    else:
        if verbose:
            print(f"  (unsupported tokenizer model {model.get('type')!r})",
                  file=sys.stderr)
        return False
    if bos is not None:
        w.add("tokenizer.ggml.bos_token_id", int(bos))
    if eos is not None:
        eos0 = eos[0] if isinstance(eos, list) else eos
        w.add("tokenizer.ggml.eos_token_id", int(eos0))
    if verbose:
        print(f"  tokenizer: {model.get('type')} vocab={len(tokens)}",
              file=sys.stderr)
    return True


def _detect_pre(blob: dict) -> str:
    """Map the tokenizer.json pre-tokenizer Split regex onto one of our
    named pre-tokenizer families (tokenizer/bpe.py PRE_PATTERNS)."""
    from kquant.tokenizer.bpe import PRE_PATTERNS

    def walk(node):
        if not isinstance(node, dict):
            return
        if node.get("type") == "Split":
            pat = node.get("pattern", {})
            yield pat.get("Regex") or pat.get("String") or ""
        for sub in node.get("pretokenizers", []) or []:
            yield from walk(sub)

    pre = blob.get("pre_tokenizer") or {}
    for rx in walk(pre):
        for name, our_rx in PRE_PATTERNS.items():
            if rx == our_rx:
                return name
    return "gpt2"


def _load_state_dict(hf_dir: str) -> dict[str, np.ndarray]:
    """Load weights from safetensors or torch .bin shards without
    instantiating the model."""
    p = Path(hf_dir)
    state: dict[str, np.ndarray] = {}
    st_files = sorted(p.glob("*.safetensors"))
    if st_files:
        from safetensors import safe_open

        for f in st_files:
            with safe_open(str(f), framework="np") as sf:
                for k in sf.keys():
                    state[k] = np.asarray(sf.get_tensor(k), dtype=np.float32)
        return state
    import torch

    for f in sorted(p.glob("*.bin")) or [p / "pytorch_model.bin"]:
        sd = torch.load(str(f), map_location="cpu", weights_only=True)
        for k, v in sd.items():
            state[k] = v.to(torch.float32).numpy()
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description="convert a HF llama-family checkpoint to GGUF")
    ap.add_argument("--hf", required=True, help="HF checkpoint directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--type", default="f16")
    ap.add_argument("--arch", default="llama")
    args = ap.parse_args(argv)
    convert(args.hf, args.out, args.type, args.arch)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()


def _convert_mamba(hf_dir: str, out_path: str, cfg: dict, state: dict,
                   recipe: str, verbose: bool) -> str:
    """HF MambaForCausalLM -> llama.cpp `mamba` GGUF (ssm_* tensor naming).

    Matmul projections follow the quant recipe; the SSM side parameters
    (conv taps/bias, dt bias, A_log, D) stay F32, matching llama.cpp's
    convert_hf_to_gguf mamba handling."""
    dim = cfg["hidden_size"]
    di = cfg.get("intermediate_size") or cfg.get("expand", 2) * dim
    # HF MambaConfig defaults time_step_rank to the STRING "auto" (truthy);
    # resolve it to ceil(dim/16) like llama.cpp's convert_hf_to_gguf does
    dtr = cfg.get("time_step_rank")
    if not isinstance(dtr, int):
        dtr = -(-dim // 16)

    w = GGUFWriter(out_path)
    w.add("general.architecture", "mamba")
    w.add("general.name", Path(hf_dir).name)
    w.add("mamba.block_count", cfg["num_hidden_layers"])
    w.add("mamba.context_length", cfg.get("max_position_embeddings", 1 << 20))
    w.add("mamba.embedding_length", dim)
    w.add("mamba.attention.layer_norm_rms_epsilon",
          float(cfg.get("layer_norm_epsilon", 1e-5)))
    w.add("mamba.ssm.conv_kernel", cfg.get("conv_kernel", 4))
    w.add("mamba.ssm.inner_size", di)
    w.add("mamba.ssm.state_size", cfg.get("state_size", 16))
    w.add("mamba.ssm.time_step_rank", dtr)
    w.add("mamba.vocab_size", cfg["vocab_size"])

    def put(gguf_name: str, arr: np.ndarray, force_f32: bool = False):
        t = (GGMLType.F32 if force_f32
             else _target_type(gguf_name, arr.shape, recipe))
        w.add_tensor(gguf_name, np.asarray(arr, np.float32), t)
        if verbose:
            print(f"  {gguf_name}: {tuple(arr.shape)} -> {t.name}",
                  file=sys.stderr)

    put("token_embd.weight", state["backbone.embeddings.weight"])
    put("output_norm.weight", state["backbone.norm_f.weight"], force_f32=True)
    if "lm_head.weight" in state:
        put("output.weight", state["lm_head.weight"])
    for i in range(cfg["num_hidden_layers"]):
        hf = f"backbone.layers.{i}."
        p = f"blk.{i}."
        put(p + "attn_norm.weight", state[hf + "norm.weight"], force_f32=True)
        put(p + "ssm_in.weight", state[hf + "mixer.in_proj.weight"])
        put(p + "ssm_conv1d.weight",
            state[hf + "mixer.conv1d.weight"][:, 0, :], force_f32=True)
        put(p + "ssm_conv1d.bias", state[hf + "mixer.conv1d.bias"],
            force_f32=True)
        put(p + "ssm_x.weight", state[hf + "mixer.x_proj.weight"])
        put(p + "ssm_dt.weight", state[hf + "mixer.dt_proj.weight"])
        put(p + "ssm_dt.bias", state[hf + "mixer.dt_proj.bias"],
            force_f32=True)
        put(p + "ssm_a", state[hf + "mixer.A_log"], force_f32=True)
        put(p + "ssm_d", state[hf + "mixer.D"], force_f32=True)
        put(p + "ssm_out.weight", state[hf + "mixer.out_proj.weight"])
    _export_tokenizer(w, hf_dir, cfg, verbose=verbose)
    w.write()
    return out_path
