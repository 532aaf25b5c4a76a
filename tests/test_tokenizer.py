"""Tokenizer tests: SPM merge order, byte fallback, BPE ranks, round-trips."""

from kquant.tokenizer.bpe import BPETokenizer, bytes_to_unicode, pretokenize
from kquant.tokenizer.spm import SPMTokenizer
from kquant.tokenizer.tokenizer import from_gguf_metadata


def _spm_vocab():
    # id: 0 unk, 1 bos, 2 eos, 3..258 bytes, then pieces
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    scores = [0.0] * len(tokens)
    ttypes = [2, 3, 3] + [6] * 256
    pieces = {
        "▁": -10.0, "h": -1.0, "e": -1.1, "l": -1.2, "o": -1.3,
        "he": -2.0, "ll": -2.1, "llo": -3.5, "hello": -5.0, "▁hello": -4.9,
        "▁w": -3.0, "or": -3.1, "ld": -3.2, "▁wor": -4.5, "▁world": -4.0,
    }
    for p, s in pieces.items():
        tokens.append(p)
        scores.append(s)
        ttypes.append(1)
    return SPMTokenizer(tokens, scores, ttypes)


def test_spm_merges_greedy_by_score():
    tok = _spm_vocab()
    ids = tok.encode("hello world", add_bos=False)
    pieces = [tok.id_to_piece(i) for i in ids]
    assert pieces == ["▁hello", "▁world"]


def test_spm_byte_fallback():
    tok = _spm_vocab()
    ids = tok.encode("héllo", add_bos=False)  # é not in vocab -> 2 utf-8 bytes
    pieces = [tok.id_to_piece(i) for i in ids]
    assert "<0xC3>" in pieces and "<0xA9>" in pieces


def test_spm_roundtrip():
    tok = _spm_vocab()
    for text in ["hello world", "hello", "héllo world"]:
        ids = tok.encode(text, add_bos=True, add_eos=True)
        assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
        assert tok.decode(ids) == text


def test_bytes_to_unicode_bijective():
    m = bytes_to_unicode()
    assert len(m) == 256
    assert len(set(m.values())) == 256


def test_pretokenize_basic():
    parts = pretokenize("Hello, world! I'm here 123456")
    assert "".join(parts) == "Hello, world! I'm here 123456"
    assert "'m" in parts
    # digit runs are capped at 3
    assert all(not (p.isdigit() and len(p) > 3) for p in parts)


def test_bpe_merge_order():
    b2u = bytes_to_unicode()
    sp = b2u[ord(" ")]
    tokens = ["h", "e", "l", "o", sp, "he", "ll", "hell", "hello", sp + "hello"]
    merges = ["h e", "l l", "he ll", "hell o", f"{sp} hello"]
    tok = BPETokenizer(tokens, merges)
    ids = tok.encode("hello hello", add_bos=False)
    assert [tok.tokens[i] for i in ids] == ["hello", sp + "hello"]
    assert tok.decode(ids) == "hello hello"


def test_bpe_roundtrip_arbitrary_bytes():
    b2u = bytes_to_unicode()
    tokens = [b2u[i] for i in range(256)]
    tok = BPETokenizer(tokens, [])
    text = "héllo \n\t世界 123"
    assert tok.decode(tok.encode(text, add_bos=False)) == text


def test_from_gguf_metadata_spm():
    md = {
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "▁hi"],
        "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0],
        "tokenizer.ggml.token_type": [2, 3, 3, 1],
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }
    tok = from_gguf_metadata(md)
    assert tok.encode("hi", add_bos=True)[0] == 1
