"""GGUF container round-trip tests (reader <-> writer)."""

import numpy as np
import pytest

from kquant.gguf import GGMLType, GGUFReader, GGUFWriter

RNG = np.random.default_rng(1)


@pytest.fixture
def gguf_file(tmp_path):
    w = GGUFWriter(tmp_path / "t.gguf")
    w.add("general.architecture", "llama")
    w.add("general.name", "fixture")
    w.add("llama.block_count", 2)
    w.add("llama.embedding_length", 64)
    w.add("llama.rope.freq_base", 10000.0)
    w.add("tokenizer.ggml.tokens", ["<unk>", "<s>", "</s>", "hello", "world"])
    w.add("tokenizer.ggml.scores", np.array([0.0, 0.0, 0.0, -1.0, -2.0], np.float32))
    w.add("tokenizer.ggml.token_type", np.array([2, 3, 3, 1, 1], np.int32))
    w.add("flag", True)
    t0 = RNG.standard_normal((8, 512)).astype(np.float32)
    t1 = RNG.standard_normal((4, 256)).astype(np.float32)
    t2 = RNG.standard_normal((64,)).astype(np.float32)
    w.add_tensor("blk.0.attn_q.weight", t0, GGMLType.Q4_K)
    w.add_tensor("blk.0.ffn_down.weight", t1, GGMLType.Q6_K)
    w.add_tensor("blk.0.attn_norm.weight", t2, GGMLType.F32)
    w.add_tensor("tok.f16", t1, GGMLType.F16)
    path = w.write()
    return path, {"t0": t0, "t1": t1, "t2": t2}


def test_metadata_roundtrip(gguf_file):
    path, _ = gguf_file
    with GGUFReader(path) as r:
        assert r.version == 3
        assert r.metadata["general.architecture"] == "llama"
        assert r.metadata["llama.block_count"] == 2
        assert abs(r.metadata["llama.rope.freq_base"] - 10000.0) < 1e-6
        assert list(r.metadata["tokenizer.ggml.tokens"]) == [
            "<unk>", "<s>", "</s>", "hello", "world",
        ]
        np.testing.assert_allclose(
            r.metadata["tokenizer.ggml.scores"], [0.0, 0.0, 0.0, -1.0, -2.0]
        )
        assert r.metadata["flag"] is True or r.metadata["flag"] == 1


def test_tensor_directory(gguf_file):
    path, tensors = gguf_file
    with GGUFReader(path) as r:
        ti = r.tensors["blk.0.attn_q.weight"]
        assert ti.shape == (8, 512)  # numpy order (ne reversed)
        assert ti.ggml_type == GGMLType.Q4_K
        assert ti.n_bytes == 8 * 512 // 256 * 144
        assert r.tensors["blk.0.attn_norm.weight"].ggml_type == GGMLType.F32


def test_tensor_data_roundtrip(gguf_file):
    path, tensors = gguf_file
    with GGUFReader(path) as r:
        f32 = r.tensor_float("blk.0.attn_norm.weight")
        np.testing.assert_array_equal(f32, tensors["t2"])
        f16 = r.tensor_float("tok.f16")
        np.testing.assert_allclose(f16, tensors["t1"], atol=2e-3, rtol=2e-3)
        q4 = r.tensor_float("blk.0.attn_q.weight")
        assert q4.shape == (8, 512)
        rms = np.sqrt(np.mean((q4 - tensors["t0"]) ** 2))
        assert rms < 0.12
        q6 = r.tensor_float("blk.0.ffn_down.weight")
        rms6 = np.sqrt(np.mean((q6 - tensors["t1"]) ** 2))
        assert rms6 < 0.03


def test_alignment(gguf_file):
    path, _ = gguf_file
    with GGUFReader(path) as r:
        assert r.data_offset % r.alignment == 0
        for ti in r.tensors.values():
            assert ti.offset % r.alignment == 0


def test_zero_copy_view(gguf_file):
    path, _ = gguf_file
    with GGUFReader(path) as r:
        b = r.tensor_bytes("blk.0.attn_q.weight")
        assert b.dtype == np.uint8
        assert not b.flags.writeable  # mmap ACCESS_READ view, no copy
