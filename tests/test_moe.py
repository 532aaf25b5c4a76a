"""MoE (Mixtral-style) model tests: load, route, generate."""

import numpy as np
import pytest

import jax.numpy as jnp

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def moe_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "moe.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, max_seq_len=128, n_experts=4, n_experts_used=2)
    write_fixture_gguf(path, cfg, seed=21, quant="q4_k_m", scale=0.08)
    cfg2, params, reader = load_model(str(path))
    return cfg2, params, reader


def test_moe_config(moe_model):
    cfg, params, _ = moe_model
    assert cfg.is_moe and cfg.n_experts == 4 and cfg.n_experts_used == 2
    layer = params["layers"][0]
    stk = layer["experts"]
    assert set(stk) == {"w_gate", "w_up", "w_down"}
    assert stk["w_gate"].shape[0] == 4  # stacked [E, N, K]
    assert stk["w_gate"].arrays["qs"].ndim == 3
    assert "gate_inp" in layer


def test_moe_generate(moe_model):
    cfg, params, _ = moe_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    out1 = eng.generate([[3, 100, 7]], max_new_tokens=6)
    out2 = eng.generate([[3, 100, 7]], max_new_tokens=6)
    assert out1 == out2
    assert all(0 <= t < cfg.vocab_size for t in out1[0])


def test_moe_routing_weights_normalized(moe_model):
    """Router softmax is over the selected top-k experts (Mixtral semantics):
    using all experts with uniform router logits must equal the plain mean."""
    import dataclasses

    from kquant.models.moe import _expert_view, moe_ffn
    from kquant.ops.qmatmul import qmatmul
    from kquant.ops.activations import swiglu
    from kquant.quant.qtensor import QTensor

    cfg, params, _ = moe_model
    layer = dict(params["layers"][0])
    # router weights -> zeros so logits are uniform
    gi = layer["gate_inp"]
    zero_gi = QTensor("dense", "dense", gi.shape,
                      {"w": jnp.zeros(gi.shape, jnp.float32)})
    layer["gate_inp"] = zero_gi
    cfg_all = dataclasses.replace(cfg, n_experts_used=cfg.n_experts)

    h = jnp.asarray(np.random.default_rng(0).standard_normal((1, 3, cfg.dim)),
                    jnp.float32)
    got = moe_ffn(layer, cfg_all, h, impl="xla")
    want = jnp.zeros_like(h)
    stk = layer["experts"]
    for e in range(cfg.n_experts):
        g = qmatmul(h, _expert_view(stk["w_gate"], e), "xla")
        u = qmatmul(h, _expert_view(stk["w_up"], e), "xla")
        want = want + qmatmul(swiglu(g, u), _expert_view(stk["w_down"], e), "xla") / cfg.n_experts
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_moe_ep_einsum_matches_loop(moe_model):
    """The expert-parallel dense-einsum path must match the per-expert loop."""
    import dataclasses

    from kquant.models.moe import moe_ffn

    cfg, params, _ = moe_model
    layer = params["layers"][0]
    h = jnp.asarray(np.random.default_rng(1).standard_normal((2, 3, cfg.dim)),
                    jnp.float32)
    loop = moe_ffn(layer, cfg, h, impl="xla")
    ep = moe_ffn(layer, dataclasses.replace(cfg, moe_impl="ep"), h, impl="xla")
    np.testing.assert_allclose(np.asarray(loop), np.asarray(ep), rtol=2e-3, atol=2e-3)


def test_moe_ep_sharded(tmp_path):
    """Full EP+TP mesh run of a MoE model on the virtual device mesh."""
    from kquant.parallel import make_mesh, make_param_put
    from jax.sharding import PartitionSpec as P

    path = tmp_path / "moe_ep.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, max_seq_len=128, n_experts=4, n_experts_used=2)
    write_fixture_gguf(path, cfg, seed=22, quant="q4_k_m", scale=0.08)

    cfg0, params0, _ = load_model(str(path))
    eng0 = InferenceEngine(cfg0, params0, max_batch=1, max_seq=64, impl="xla")
    want = eng0.generate([[3, 100, 7]], max_new_tokens=5)

    mesh = make_mesh(data=1, expert=4, model=2)
    cfg2, params, _ = load_model(str(path), put=make_param_put(mesh))
    assert cfg2.moe_impl == "ep"
    qs = params["layers"][0]["experts"]["w_gate"].arrays["qs"]
    assert qs.sharding.spec[0] == "expert"
    eng = InferenceEngine(cfg2, params, max_batch=1, max_seq=64, impl="xla")
    got = eng.generate([[3, 100, 7]], max_new_tokens=5)
    assert got == want


def test_moe_decode_matches_prefill(moe_model):
    cfg, params, _ = moe_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    tokens = [3, 100, 7, 256, 42]
    full, _, _ = eng.prefill([tokens], eng.new_cache(1))
    l2, cache, lens = eng.prefill([tokens[:2]], eng.new_cache(1))
    pos = jnp.asarray(lens)
    for t in tokens[2:]:
        l2, cache = eng.decode_step(jnp.asarray([t], jnp.int32), pos, cache)
        pos = pos + 1
    a, b = np.asarray(full[0]), np.asarray(l2[0])
    assert np.argmax(a) == np.argmax(b)
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05 * np.abs(a).max())
