"""Tokenizer layer: SPM + byte-level BPE built from GGUF metadata."""

from kquant.tokenizer.tokenizer import Tokenizer, from_gguf_metadata  # noqa: F401
