"""Tensor/data-parallel sharding on the virtual 8-device CPU mesh
(SURVEY.md section 4 item (e)): sharded execution must match single-device."""

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.parallel import make_mesh, make_param_put, shard_cache
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "tp.gguf"
    # dims chosen divisible by model=4: Hkv=4, dim=128, ffn=256
    cfg = tiny_config(n_layers=2, dim=128, n_heads=8, n_kv_heads=4, ffn_dim=256,
                      vocab_size=512, max_seq_len=128)
    write_fixture_gguf(path, cfg, seed=11, quant="q4_k_m", scale=0.08)
    return str(path)


def test_mesh_axes():
    mesh = make_mesh(data=2, model=4)
    assert mesh.shape == {"data": 2, "pipe": 1, "expert": 1, "model": 4}


def test_qtensor_sharded(model_path):
    mesh = make_mesh(data=1, model=4)
    cfg, params, _ = load_model(model_path, put=make_param_put(mesh))
    wq = params["layers"][0]["wq"]
    sh = wq.arrays["qs"].sharding
    assert sh.spec == P(None, "model")
    wo = params["layers"][0]["wo"]
    assert wo.arrays["qs"].sharding.spec == P("model", None)
    # norms replicated
    nrm = params["layers"][0]["attn_norm"].arrays["w"].sharding
    assert nrm.spec == P()


def test_tp_matches_single_device(model_path):
    cfg, params0, _ = load_model(model_path)
    eng0 = InferenceEngine(cfg, params0, max_batch=2, max_seq=64, impl="xla")
    rows = [[3, 100, 7, 256], [9, 300, 17]]
    l0, _, _ = eng0.prefill(rows, eng0.new_cache(2))

    mesh = make_mesh(data=2, model=4)
    cfg, params, _ = load_model(model_path, put=make_param_put(mesh))
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    cache = shard_cache(eng.new_cache(2), mesh)
    l1, cache, lens = eng.prefill(rows, cache)
    np.testing.assert_allclose(np.asarray(l0), np.asarray(l1), rtol=2e-2, atol=2e-2)

    # decode under sharding
    import jax.numpy as jnp

    tok = jnp.asarray([5, 7], jnp.int32)
    ld, cache = eng.decode_step(tok, jnp.asarray(lens), cache)
    assert ld.shape == (2, cfg.vocab_size)
    assert np.isfinite(np.asarray(ld)).all()


def test_generate_sharded_matches(model_path):
    cfg, params0, _ = load_model(model_path)
    eng0 = InferenceEngine(cfg, params0, max_batch=1, max_seq=64, impl="xla")
    out0 = eng0.generate([[3, 100, 7]], max_new_tokens=5)

    mesh = make_mesh(data=1, model=4)
    cfg, params, _ = load_model(model_path, put=make_param_put(mesh))
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    out1 = eng.generate([[3, 100, 7]], max_new_tokens=5)
    assert out0 == out1
