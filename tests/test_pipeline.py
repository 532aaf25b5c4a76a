"""Pipeline parallelism on the virtual 8-device CPU mesh: stage-sharded
layers (shard_map manual over 'pipe', GSPMD auto TP inside stages) must match
single-device execution — prefill, decode, generation, PP x TP, and the
GPipe microbatch schedule."""

import numpy as np
import pytest

import jax.numpy as jnp

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.parallel import (
    make_mesh,
    make_param_put,
    make_pp_forward,
    shard_cache_pp,
    stack_pp_params,
)
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "pp.gguf"
    # 4 layers -> 2 or 4 stages; dims divisible by model=2
    cfg = tiny_config(n_layers=4, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=256, max_seq_len=64)
    write_fixture_gguf(path, cfg, seed=7, quant="q4_k_m", scale=0.08)
    return str(path)


@pytest.fixture(scope="module")
def baseline(model_path):
    cfg, params, _ = load_model(model_path)
    eng = InferenceEngine(cfg, params, max_batch=4, max_seq=64, impl="xla")
    rows = [[3, 100, 7, 9], [11, 13], [2, 4, 6], [200, 201, 202, 203]]
    logits, cache, lens = eng.prefill(rows, eng.new_cache(4))
    return cfg, rows, np.asarray(logits), lens, eng


def _pp_engine(model_path, pipe, model=1, n_micro=1, max_batch=4):
    mesh = make_mesh(pipe=pipe, model=model)
    cfg, params, _ = load_model(model_path, put=make_param_put(mesh))
    params = stack_pp_params(params, mesh)
    eng = InferenceEngine(cfg, params, max_batch=max_batch, max_seq=64,
                          impl="xla", forward_fn=make_pp_forward(mesh, n_micro))
    return eng, mesh


@pytest.mark.parametrize("pipe,model,n_micro", [(2, 1, 1), (4, 1, 2), (2, 2, 2)])
def test_pp_prefill_decode_parity(model_path, baseline, pipe, model, n_micro):
    cfg, rows, l0, lens, eng0 = baseline
    eng, mesh = _pp_engine(model_path, pipe, model, n_micro)
    cache = shard_cache_pp(eng.new_cache(4), mesh)
    l1, cache, lens1 = eng.prefill(rows, cache)
    np.testing.assert_allclose(l0, np.asarray(l1), atol=3e-3)

    tok = jnp.asarray(np.argmax(l0, axis=-1), jnp.int32)
    d1, cache = eng.decode_step(tok, jnp.asarray(lens1), cache)
    # reference decode on the single-device engine
    c0 = eng0.new_cache(4)
    _, c0, _ = eng0.prefill(rows, c0)
    d0, _ = eng0.decode_step(tok, jnp.asarray(lens), c0)
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), atol=3e-3)


def test_pp_generate_matches(model_path):
    cfg, params0, _ = load_model(model_path)
    eng0 = InferenceEngine(cfg, params0, max_batch=2, max_seq=64, impl="xla")
    out0 = eng0.generate([[3, 100, 7], [5, 9]], max_new_tokens=6)

    eng, mesh = _pp_engine(model_path, pipe=2, n_micro=2, max_batch=2)
    # generate() builds an unsharded cache internally; parity must still hold
    out1 = eng.generate([[3, 100, 7], [5, 9]], max_new_tokens=6)
    assert out0 == out1


def test_pp_quantized_kv(model_path):
    cfg, params0, _ = load_model(model_path)
    eng0 = InferenceEngine(cfg, params0, max_batch=1, max_seq=64, impl="xla",
                           kv_quantized=True)
    out0 = eng0.generate([[3, 100, 7]], max_new_tokens=5)

    mesh = make_mesh(pipe=2)
    cfg, params, _ = load_model(model_path, put=make_param_put(mesh))
    params = stack_pp_params(params, mesh)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla",
                          kv_quantized=True, forward_fn=make_pp_forward(mesh))
    out1 = eng.generate([[3, 100, 7]], max_new_tokens=5)
    assert out0 == out1


def test_pp_rejects_indivisible_layers(model_path):
    mesh = make_mesh(pipe=3)
    cfg, params, _ = load_model(model_path)
    with pytest.raises(ValueError, match="not divisible"):
        stack_pp_params(params, mesh)
