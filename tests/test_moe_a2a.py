"""Ragged all_to_all expert dispatch (models.moe_a2a) on the virtual
8-device CPU mesh: with capacity_factor >= E/top_k (no drops) it must match
the dense per-expert loop exactly; capacity overflow must drop tokens, not
corrupt them; and the engine path must generate identically to single-device."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.parallel import make_mesh, make_param_put
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def moe_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "a2a.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=96,
                      vocab_size=256, max_seq_len=64, n_experts=4,
                      n_experts_used=2)
    write_fixture_gguf(path, cfg, seed=9, quant="q4_k_m", scale=0.08)
    return str(path)


def test_a2a_matches_loop(moe_model):
    from kquant.models.moe import moe_ffn
    from kquant.models.moe_a2a import moe_ffn_a2a

    mesh = make_mesh(expert=4)
    cfg, params, _ = load_model(moe_model, put=make_param_put(mesh, "a2a"))
    assert cfg.moe_impl == "a2a"
    layer = params["layers"][0]
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.normal(size=(2, 8, cfg.dim)).astype(np.float32))

    loop = moe_ffn(layer, dataclasses.replace(cfg, moe_impl="loop"), h, "xla")
    # E/top_k = 2 guarantees zero capacity drops
    a2a = moe_ffn_a2a(layer, cfg, h, mesh, impl="xla", capacity_factor=4.0)
    np.testing.assert_allclose(np.asarray(loop), np.asarray(a2a),
                               rtol=1e-4, atol=1e-4)


def test_a2a_token_axis_padding(moe_model):
    """Token count not divisible by the expert axis (decode: B*T=3, ep=4)."""
    from kquant.models.moe import moe_ffn
    from kquant.models.moe_a2a import moe_ffn_a2a

    mesh = make_mesh(expert=4)
    cfg, params, _ = load_model(moe_model, put=make_param_put(mesh, "a2a"))
    layer = params["layers"][0]
    rng = np.random.default_rng(1)
    h = jnp.asarray(rng.normal(size=(3, 1, cfg.dim)).astype(np.float32))
    loop = moe_ffn(layer, dataclasses.replace(cfg, moe_impl="loop"), h, "xla")
    a2a = moe_ffn_a2a(layer, cfg, h, mesh, impl="xla", capacity_factor=8.0)
    np.testing.assert_allclose(np.asarray(loop), np.asarray(a2a),
                               rtol=1e-4, atol=1e-4)


def test_a2a_capacity_drop(moe_model):
    """Tiny capacity must produce finite (partial) outputs, never NaN/garbage."""
    from kquant.models.moe_a2a import moe_ffn_a2a

    mesh = make_mesh(expert=4)
    cfg, params, _ = load_model(moe_model, put=make_param_put(mesh, "a2a"))
    layer = params["layers"][0]
    rng = np.random.default_rng(2)
    h = jnp.asarray(rng.normal(size=(2, 16, cfg.dim)).astype(np.float32))
    out = moe_ffn_a2a(layer, cfg, h, mesh, impl="xla", capacity_factor=0.25)
    assert np.isfinite(np.asarray(out)).all()


def test_a2a_default_capacity_lossless_under_skew(moe_model):
    """DEFAULT capacity_factor (E/top_k -> C = n_local) must drop nothing
    even when EVERY token routes to the same two experts — the inference
    guarantee VERDICT item 6 asks for: the default cannot alter outputs."""
    from kquant.models.moe import moe_ffn
    from kquant.models.moe_a2a import moe_ffn_a2a
    from kquant.quant.qtensor import QTensor

    mesh = make_mesh(expert=4)
    cfg, params, _ = load_model(moe_model, put=make_param_put(mesh, "a2a"))
    layer = dict(params["layers"][0])
    # adversarial router: every token's top-2 = experts {0, 1}
    w = np.full((cfg.n_experts, cfg.dim), -8.0, np.float32)
    w[0, :] = 8.0 / cfg.dim
    w[1, :] = 4.0 / cfg.dim
    layer["gate_inp"] = QTensor("dense", "dense", w.shape, {"w": jnp.asarray(w)})
    rng = np.random.default_rng(3)
    h = jnp.asarray(np.abs(rng.normal(size=(2, 16, cfg.dim))).astype(np.float32))

    loop = moe_ffn(layer, dataclasses.replace(cfg, moe_impl="loop"), h, "xla")
    a2a = moe_ffn_a2a(layer, cfg, h, mesh, impl="xla")  # default capacity
    np.testing.assert_allclose(np.asarray(loop), np.asarray(a2a),
                               rtol=1e-4, atol=1e-4)


def test_a2a_engine_generate_matches(moe_model):
    cfg0, params0, _ = load_model(moe_model)
    eng0 = InferenceEngine(cfg0, params0, max_batch=2, max_seq=64, impl="xla")
    out0 = eng0.generate([[3, 5, 7], [11, 13]], max_new_tokens=5)

    mesh = make_mesh(expert=2, model=2)
    cfg, params, _ = load_model(moe_model, put=make_param_put(mesh, "a2a"))
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla",
                          mesh=mesh)
    out1 = eng.generate([[3, 5, 7], [11, 13]], max_new_tokens=5)
    assert out0 == out1
