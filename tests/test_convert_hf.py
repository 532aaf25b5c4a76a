"""Gold-standard cross-implementation parity: a random HF LlamaForCausalLM,
converted to GGUF by our converter, must produce the same logits in our
engine as transformers does in torch. This pins every convention at once:
name mapping, q/k rotary permutation, rope mode, GQA grouping, norm eps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=256,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg)
    model.eval()
    d = tmp_path_factory.mktemp("hf") / "tiny-llama-hf"
    model.save_pretrained(str(d))
    return str(d), model


def test_convert_and_logit_parity(hf_checkpoint, tmp_path):
    from kquant.runtime import InferenceEngine, load_model
    from kquant.tools.convert_hf import convert

    hf_dir, model = hf_checkpoint
    out = str(tmp_path / "converted.gguf")
    convert(hf_dir, out, recipe="f16", verbose=False)

    cfg, params, reader = load_model(out)
    assert cfg.n_layers == 2 and cfg.n_kv_heads == 2 and cfg.rope.mode == "neox"  # loader canonicalizes norm -> neox

    tokens = [3, 100, 7, 256, 42, 9]
    with torch.no_grad():
        hf_logits = model(torch.tensor([tokens])).logits[0].numpy()

    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    logits, _, _ = eng.prefill([tokens], eng.new_cache(1))
    ours_last = np.asarray(logits[0], np.float64)
    want_last = hf_logits[-1].astype(np.float64)

    denom = np.sqrt((ours_last**2).mean() * (want_last**2).mean())
    corr = float((ours_last * want_last).mean() / denom)
    assert corr > 0.995, corr
    assert np.argmax(ours_last) == np.argmax(want_last)
    # also check an interior position via full logits
    logits_full, _ = eng._step(
        eng.params,
        np.asarray([tokens], np.int32),
        np.arange(len(tokens), dtype=np.int32)[None, :],
        eng.new_cache(1),
        False,
    )
    mid = np.asarray(logits_full[0, 2], np.float64)
    want_mid = hf_logits[2].astype(np.float64)
    corr_mid = float(
        (mid * want_mid).mean()
        / np.sqrt((mid**2).mean() * (want_mid**2).mean())
    )
    assert corr_mid > 0.995, corr_mid


def test_convert_quantized_still_agrees(hf_checkpoint, tmp_path):
    from kquant.runtime import InferenceEngine, load_model
    from kquant.tools.convert_hf import convert

    hf_dir, model = hf_checkpoint
    out = str(tmp_path / "q8.gguf")
    convert(hf_dir, out, recipe="q8_0", verbose=False)
    cfg, params, _ = load_model(out)
    tokens = [3, 100, 7]
    with torch.no_grad():
        hf_logits = model(torch.tensor([tokens])).logits[0, -1].numpy()
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    logits, _, _ = eng.prefill([tokens], eng.new_cache(1))
    a = np.asarray(logits[0], np.float64)
    assert np.argmax(a) == int(np.argmax(hf_logits))
