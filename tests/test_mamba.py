"""Mamba (recurrent memory context) parity vs the transformers oracle.

The GGUF is written directly from a random-init HF MambaForCausalLM's
weights (llama.cpp `mamba` tensor naming), then the whole engine chain —
masked right-padded prefill, recurrent decode, greedy generation, session
save/restore — is checked against torch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from kquant.gguf import GGMLType, GGUFWriter  # noqa: E402
from kquant.runtime import InferenceEngine, load_model  # noqa: E402

D, DI, DS, DC, DTR, L, V = 64, 128, 16, 4, 4, 2, 512


@pytest.fixture(scope="module")
def hf_and_gguf(tmp_path_factory):
    from transformers import MambaConfig, MambaForCausalLM

    torch.manual_seed(0)
    cfg = MambaConfig(
        vocab_size=V, hidden_size=D, state_size=DS, num_hidden_layers=L,
        conv_kernel=DC, expand=2, time_step_rank=DTR,
        use_conv_bias=True, use_bias=False, tie_word_embeddings=False,
    )
    model = MambaForCausalLM(cfg).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    path = tmp_path_factory.mktemp("mamba") / "mamba.gguf"
    w = GGUFWriter(str(path))
    for k, v in {
        "general.architecture": "mamba",
        "mamba.block_count": L,
        "mamba.context_length": 256,
        "mamba.embedding_length": D,
        "mamba.attention.layer_norm_rms_epsilon": 1e-5,
        "mamba.ssm.conv_kernel": DC,
        "mamba.ssm.inner_size": DI,
        "mamba.ssm.state_size": DS,
        "mamba.ssm.time_step_rank": DTR,
        "mamba.vocab_size": V,
    }.items():
        w.add(k, v)

    def put(name, arr):
        w.add_tensor(name, np.asarray(arr, np.float32), GGMLType.F32)

    put("token_embd.weight", sd["backbone.embeddings.weight"])
    put("output_norm.weight", sd["backbone.norm_f.weight"])
    put("output.weight", sd["lm_head.weight"])
    for i in range(L):
        hf = f"backbone.layers.{i}."
        p = f"blk.{i}."
        put(p + "attn_norm.weight", sd[hf + "norm.weight"])
        put(p + "ssm_in.weight", sd[hf + "mixer.in_proj.weight"])
        put(p + "ssm_conv1d.weight",
            sd[hf + "mixer.conv1d.weight"][:, 0, :])  # [di, 1, dc] -> [di, dc]
        put(p + "ssm_conv1d.bias", sd[hf + "mixer.conv1d.bias"])
        put(p + "ssm_x.weight", sd[hf + "mixer.x_proj.weight"])
        put(p + "ssm_dt.weight", sd[hf + "mixer.dt_proj.weight"])
        put(p + "ssm_dt.bias", sd[hf + "mixer.dt_proj.bias"])
        put(p + "ssm_a", sd[hf + "mixer.A_log"])
        put(p + "ssm_d", sd[hf + "mixer.D"])
        put(p + "ssm_out.weight", sd[hf + "mixer.out_proj.weight"])
    w.write()
    return model, str(path)


@pytest.fixture(scope="module")
def engine(hf_and_gguf):
    _, path = hf_and_gguf
    cfg, params, reader = load_model(path)
    assert cfg.is_recurrent
    return InferenceEngine(cfg, params, max_batch=2, max_seq=96)


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.tensor([ids])).logits[0].numpy()


def test_prefill_logits_match(hf_and_gguf, engine):
    model, _ = hf_and_gguf
    ids = [3, 77, 200, 145, 9, 411, 32]
    want = _hf_logits(model, ids)[-1]
    logits, cache, lens = engine.prefill([ids], engine.new_cache(1))
    got = np.asarray(logits[0], np.float32)
    assert np.argmax(got) == np.argmax(want)
    corr = np.corrcoef(got, want)[0, 1]
    assert corr > 0.999, corr


def test_padded_batched_prefill_masks_state(hf_and_gguf, engine):
    """Right-padded rows must produce the same logits as unpadded ones —
    pads may not touch the recurrent state."""
    model, _ = hf_and_gguf
    a = [3, 77, 200, 145, 9, 411, 32]
    b = [8, 12, 400]
    logits, cache, lens = engine.prefill([a, b], engine.new_cache(2))
    for ids, row in ((a, 0), (b, 1)):
        want = _hf_logits(model, ids)[-1]
        got = np.asarray(logits[row], np.float32)
        assert np.argmax(got) == np.argmax(want), row
        assert np.corrcoef(got, want)[0, 1] > 0.999


def test_greedy_generation_matches_hf(hf_and_gguf, engine):
    model, _ = hf_and_gguf
    ids = [3, 77, 200, 145, 9]
    n_new = 16
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([ids]), max_new_tokens=n_new, do_sample=False,
        )[0].tolist()[len(ids):]
    ours = engine.generate([ids], max_new_tokens=n_new)[0]
    assert ours == hf_out


def test_chunked_prefill_equals_oneshot(hf_and_gguf, engine):
    """Prefill then decode must carry the state exactly: feeding the prompt
    in two prefill+decode stages matches the one-shot prefill logits."""
    ids = [3, 77, 200, 145, 9, 411, 32, 18]
    one, _, _ = engine.prefill([ids], engine.new_cache(1))

    logits, cache, lens = engine.prefill([ids[:-1]], engine.new_cache(1))
    step_logits, cache = engine.decode_step(
        jnp.asarray([ids[-1]], jnp.int32), jnp.asarray(lens), cache)
    np.testing.assert_allclose(
        np.asarray(step_logits[0], np.float32),
        np.asarray(one[0], np.float32), atol=2e-2, rtol=0)


def test_session_roundtrip(tmp_path, hf_and_gguf, engine):
    ids = [3, 77, 200, 145, 9]
    logits, cache, lens = engine.prefill([ids], engine.new_cache(1))
    p = str(tmp_path / "sess.npz")
    engine.save_session(p, cache, lens)
    cache2, lens2 = engine.load_session(p)
    np.testing.assert_array_equal(np.asarray(cache.ssm), np.asarray(cache2.ssm))
    np.testing.assert_array_equal(np.asarray(cache.conv), np.asarray(cache2.conv))
    # decoding from the restored state matches
    a, _ = engine.decode_step(jnp.asarray([7], jnp.int32), jnp.asarray(lens), cache)
    b, _ = engine.decode_step(jnp.asarray([7], jnp.int32), jnp.asarray(lens2), cache2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_convert_hf_mamba(tmp_path, hf_and_gguf):
    """tools/convert_hf on a saved HF MambaForCausalLM produces a GGUF whose
    engine logits match torch (the real-checkpoint conversion path)."""
    from kquant.tools.convert_hf import convert

    model, _ = hf_and_gguf
    hf_dir = tmp_path / "hf"
    model.save_pretrained(str(hf_dir), safe_serialization=True)
    out = tmp_path / "conv.gguf"
    convert(str(hf_dir), str(out), recipe="f32", verbose=False)

    cfg, params, reader = load_model(str(out))
    assert cfg.is_recurrent and cfg.ssm_d_inner == DI
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64)
    ids = [3, 77, 200, 145, 9, 411]
    want = _hf_logits(model, ids)[-1]
    logits, _, _ = eng.prefill([ids], eng.new_cache(1))
    got = np.asarray(logits[0], np.float32)
    assert np.argmax(got) == np.argmax(want)
    assert np.corrcoef(got, want)[0, 1] > 0.999


def test_continuous_batching_mamba(hf_and_gguf):
    """The serving loop works over the recurrent cache: slot prefill masks
    pads, outputs match single-stream generate."""
    from kquant.serving.scheduler import ContinuousBatcher, Request

    _, path = hf_and_gguf
    cfg, params, reader = load_model(path)
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=96)
    prompts = [[3, 77, 200, 145, 9], [8, 12, 400]]
    want = [eng.generate([p], max_new_tokens=8)[0] for p in prompts]

    cb = ContinuousBatcher(eng)
    for p in prompts:
        cb.submit(Request(prompt=p, max_new_tokens=8))
    done = cb.run()
    got = {tuple(r.prompt): r.output for r in done}
    for p, w in zip(prompts, want):
        assert got[tuple(p)] == w, (got[tuple(p)], w)


def test_staggered_admission_and_slot_reuse_mamba(hf_and_gguf):
    """Recurrent serving with requests admitted AFTER ticks have run and
    into REUSED slots: inactive slots' dummy decodes must not drift their
    recurrent state, and a reused slot must prefill from zeros, not the
    previous request's final state (ADVICE r3 high)."""
    from kquant.serving.scheduler import ContinuousBatcher, Request

    _, path = hf_and_gguf
    cfg, params, reader = load_model(path)
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=96)
    prompts = [[3, 77, 200, 145, 9], [8, 12, 400], [41, 7, 300, 18]]
    want = [eng.generate([p], max_new_tokens=6)[0] for p in prompts]

    cb = ContinuousBatcher(eng)
    # r0 alone: slot 1 stays inactive and runs dummy decodes for 3 ticks
    cb.submit(Request(prompt=prompts[0], max_new_tokens=6))
    for _ in range(3):
        cb.step()
    # r1 admitted into the drifted slot 1 mid-stream
    cb.submit(Request(prompt=prompts[1], max_new_tokens=6))
    while cb.has_work():
        cb.step()
    # r2 reuses a slot that held a finished request's final state
    cb.submit(Request(prompt=prompts[2], max_new_tokens=6))
    done = cb.run()  # returns everything finished so far (r0, r1, r2)
    got = {tuple(r.prompt): r.output for r in done}
    for p, w in zip(prompts, want):
        assert got[tuple(p)] == w, (p, got[tuple(p)], w)
