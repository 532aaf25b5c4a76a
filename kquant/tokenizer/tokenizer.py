"""Tokenizer facade: build the right tokenizer from GGUF metadata."""

from __future__ import annotations

from typing import Protocol

from kquant.tokenizer.bpe import BPETokenizer
from kquant.tokenizer.spm import SPMTokenizer


class Tokenizer(Protocol):
    def encode(self, text: str, add_bos: bool = ..., add_eos: bool = ...) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...
    vocab_size: int


def from_gguf_metadata(md: dict) -> SPMTokenizer | BPETokenizer:
    model = md.get("tokenizer.ggml.model", "llama")
    tokens = list(md["tokenizer.ggml.tokens"])
    bos = int(md.get("tokenizer.ggml.bos_token_id", 1))
    eos = int(md.get("tokenizer.ggml.eos_token_id", 2))
    if model in ("llama", "spm"):
        scores = [float(s) for s in md.get("tokenizer.ggml.scores", [0.0] * len(tokens))]
        ttypes = [int(t) for t in md.get("tokenizer.ggml.token_type", [1] * len(tokens))]
        unk = int(md.get("tokenizer.ggml.unknown_token_id", 0))
        prefix = bool(md.get("tokenizer.ggml.add_space_prefix", True))
        return SPMTokenizer(tokens, scores, ttypes, bos, eos, unk, prefix)
    if model in ("gpt2", "bpe", "llama3"):
        merges = list(md.get("tokenizer.ggml.merges", []))
        ttypes = [int(t) for t in md.get("tokenizer.ggml.token_type", [1] * len(tokens))]
        special = {i for i, t in enumerate(ttypes) if t in (3, 4)}  # CONTROL
        pre = str(md.get("tokenizer.ggml.pre", "llama3"))
        return BPETokenizer(tokens, merges, bos, eos, special, pre=pre)
    raise ValueError(f"unknown tokenizer model {model!r}")
