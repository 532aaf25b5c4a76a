"""Cross-validation of the tokenizers against the HuggingFace `tokenizers`
library (the engine behind every HF fast tokenizer) — VERDICT r1 item 5:
self-consistency tests are not enough; one mis-split token invalidates a
real-model perplexity comparison.

Strategy (zero-egress: no vocab downloads): TRAIN a small tokenizer with
`tokenizers` on an in-test corpus, then run BOTH implementations with the
same vocab/merges over a hostile text set and require identical ids.

- BPE: byte-level BPE with the EXACT llama-3 Split regex as pre-tokenizer —
  validates our `regex`-based pretokenize AND rank-merge application.
- SPM: llama.cpp's SPM tokenizer is score-ranked bigram merging; for
  sentencepiece-BPE vocabs this is equivalent to rank-BPE with
  score = -merge_rank (the transform transformers' convert_slow_tokenizer
  relies on). We train a Metaspace BPE, derive SPM scores from merge ranks,
  and require our SPMTokenizer to reproduce the oracle's segmentation.
"""

import pytest

tokenizers = pytest.importorskip("tokenizers")
regex = pytest.importorskip("regex")

from tokenizers import Tokenizer, models, pre_tokenizers, trainers  # noqa: E402

from kquant.tokenizer.bpe import PRE_PATTERNS, BPETokenizer  # noqa: E402
from kquant.tokenizer.spm import SPM_SPACE, SPMTokenizer  # noqa: E402

TRAIN_CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "Pack my box with five dozen liquor jugs!",
    "In 2024, 15% of 378 engineers shipped 1234567 lines of code.",
    "def tokenize(text: str) -> list[int]:\n    return ids",
    "  leading spaces   and\ttabs\nand\r\nnewlines everywhere  ",
    "don't can't won't I'll you're we've they'd it's I'm",
    "naïve café résumé Zürich Москва 東京 مرحبا שלום",
    "!!!??? ... --- ###$$$ @@@ ((()))[[]]{{}}",
    "CamelCase snake_case kebab-case SCREAMING_CASE x86_64",
    "http://example.com/path?query=1&other=2#fragment",
]

HOSTILE_TEXTS = [
    "Hello, world!",
    "don't",
    "  double  spaces  ",
    "tabs\tand\nnewlines\r\nmixed \n\n  \n",
    "12345678901234",
    "a1b2c3 42x 100,000.99",
    "émigré's naïveté — “smart quotes” …",
    "日本語のテキスト and English mixed 混合",
    "x('s)('t)('re) its' 'd",
    "trailing space ",
    " leading space",
    "",
    "\n",
    "    ",
    "🤖 emoji 🚀 test 🇺🇸",
    "a b c",  # exotic whitespace
    "word​word",  # zero-width space
]


@pytest.fixture(scope="module")
def bpe_pair():
    """(our BPETokenizer, oracle Tokenizer) sharing one trained vocab."""
    pat = tokenizers.Regex(PRE_PATTERNS["llama3"])
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(pat, behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<s>", "</s>"], show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(TRAIN_CORPUS, trainer)
    import json

    blob = json.loads(tok.to_str())
    vocab = blob["model"]["vocab"]  # piece -> id
    merges = blob["model"]["merges"]  # list of [a, b] or "a b"
    tokens = [None] * len(vocab)
    for piece, i in vocab.items():
        tokens[i] = piece
    merge_strs = [
        m if isinstance(m, str) else f"{m[0]} {m[1]}" for m in merges
    ]
    ours = BPETokenizer(tokens, merge_strs, bos_id=0, eos_id=1,
                        special_ids={0, 1}, pre="llama3")
    return ours, tok


def test_bpe_matches_hf_tokenizers(bpe_pair):
    ours, oracle = bpe_pair
    for text in HOSTILE_TEXTS + TRAIN_CORPUS:
        want = oracle.encode(text).ids
        got = ours.encode(text, add_bos=False)
        assert got == want, f"mismatch on {text!r}: {got} != {want}"


def test_bpe_decode_roundtrip(bpe_pair):
    ours, _ = bpe_pair
    for text in HOSTILE_TEXTS + TRAIN_CORPUS:
        ids = ours.encode(text, add_bos=False)
        assert ours.decode(ids) == text


def test_pretokenize_matches_hf_split():
    """Our regex splitter must byte-match the tokenizers library's Split
    pre-tokenizer with the same llama-3 pattern."""
    from kquant.tokenizer.bpe import pretokenize

    pat = tokenizers.Regex(PRE_PATTERNS["llama3"])
    pt = pre_tokenizers.Split(pat, behavior="isolated")
    for text in HOSTILE_TEXTS + TRAIN_CORPUS:
        want = [s for s, _ in pt.pre_tokenize_str(text)]
        got = pretokenize(text, "llama3")
        assert got == want, f"split mismatch on {text!r}"


@pytest.fixture(scope="module")
def spm_pair():
    """(our SPMTokenizer, oracle Tokenizer): Metaspace BPE trained in-test;
    SPM scores derived as -merge_rank (the sentencepiece-BPE equivalence)."""
    tok = Tokenizer(models.BPE(byte_fallback=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement=SPM_SPACE, prepend_scheme="never", split=True
    )
    byte_tokens = [f"<0x{b:02X}>" for b in range(256)]
    trainer = trainers.BpeTrainer(
        vocab_size=500, show_progress=False,
        special_tokens=["<unk>", "<s>", "</s>"] + byte_tokens,
        initial_alphabet=[SPM_SPACE],
        limit_alphabet=1000,
    )
    tok.train_from_iterator(
        [t.replace(" ", SPM_SPACE) for t in TRAIN_CORPUS], trainer
    )
    import json

    blob = json.loads(tok.to_str())
    vocab = blob["model"]["vocab"]
    merges = blob["model"]["merges"]
    tokens = [None] * len(vocab)
    for piece, i in vocab.items():
        tokens[i] = piece
    scores = [0.0] * len(tokens)
    rank_of = {}
    for r, m in enumerate(merges):
        a, b = (m.split(" ", 1) if isinstance(m, str) else m)
        rank_of[a + b] = r
    for i, t in enumerate(tokens):
        scores[i] = -float(rank_of[t]) if t in rank_of else -1e9
    ttypes = [1] * len(tokens)
    for b in range(256):
        ttypes[vocab[f"<0x{b:02X}>"]] = 6  # BYTE
    for s in ("<unk>", "<s>", "</s>"):
        ttypes[vocab[s]] = 3  # CONTROL
    ours = SPMTokenizer(tokens, scores, ttypes, bos_id=vocab["<s>"],
                        eos_id=vocab["</s>"], unk_id=vocab["<unk>"],
                        add_space_prefix=False)
    return ours, tok


def test_spm_score_merge_matches_rank_bpe(spm_pair):
    ours, oracle = spm_pair
    for text in TRAIN_CORPUS + HOSTILE_TEXTS:
        spm_text = text.replace(" ", SPM_SPACE)
        want = oracle.encode(spm_text).ids
        got = ours.encode(text, add_bos=False)
        assert got == want, f"mismatch on {text!r}: {got} != {want}"
