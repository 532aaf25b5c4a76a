"""Tests for aux ops/utils: activation quant, roofline accounting, rope YaRN."""

import numpy as np

import jax.numpy as jnp

from kquant.ops.act_quant import dequantize_activations, quantize_activations
from kquant.ops.rope import RopeParams, rope_cos_sin


def test_act_quant_roundtrip():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 256)), jnp.float32)
    xq, scales, gsums = quantize_activations(x)
    assert xq.dtype == jnp.int8
    assert scales.shape == (4, 8)
    y = dequantize_activations(xq, scales)
    rel = np.abs(np.asarray(y - x)).max() / np.abs(np.asarray(x)).max()
    assert rel < 0.02


def test_act_quant_gsums():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 64)), jnp.float32)
    xq, scales, gsums = quantize_activations(x)
    # gsums approximate the true group sums (the Q8_K bsums contract)
    true = np.asarray(x).reshape(2, 2, 32).sum(axis=-1)
    np.testing.assert_allclose(np.asarray(gsums), true, atol=0.15)


def test_roofline_accounting():
    from kquant.models.fixtures import random_qparams, tiny_config
    from kquant.utils.roofline import model_bytes_per_token, roofline_report

    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2,
                      ffn_dim=128, vocab_size=512)
    params = random_qparams(cfg)
    mb = model_bytes_per_token(params)
    assert mb["weight_bytes"] > 0
    # q4 with f32 scales/mins = 0.75 B/elem; weights exclude tok_embd rows
    rep = roofline_report(params, cfg, measured_tok_s=100.0,
                          device_kind="NVIDIA H100 80GB HBM3",
                          batch=1, seq_len=128)
    assert rep["roofline_tok_s"] > 0
    assert 0 < rep["fraction_of_roofline"] < 1e6


def test_yarn_rope_differs_from_plain():
    plain = RopeParams(head_dim=64, n_rot=64, freq_base=10000.0)
    yarn = RopeParams(head_dim=64, n_rot=64, freq_base=10000.0,
                      freq_scale=0.25, ext_factor=1.0, n_ctx_orig=2048)
    pos = jnp.asarray([100.0])
    c0, s0 = rope_cos_sin(pos, plain)
    c1, s1 = rope_cos_sin(pos, yarn)
    assert not np.allclose(np.asarray(c0), np.asarray(c1))
    # yarn attn mscale amplifies magnitude
    assert np.abs(np.asarray(c1)).max() > 1.0


def test_rope_neox_canonicalization_identity():
    """loader._rope_neox_perm: rope_norm(x @ W.T) == inv_perm(rope_neox(x @ W[perm].T))
    and QK^T is invariant when both q and k carry the permutation."""
    import numpy as np

    from kquant.ops.rope import RopeParams, apply_rope, rope_cos_sin
    from kquant.runtime.loader import _rope_neox_perm

    rng = np.random.default_rng(3)
    H, D = 3, 16
    T = 5
    W = rng.standard_normal((H * D, 64)).astype(np.float32)
    x = rng.standard_normal((1, T, 64)).astype(np.float32)
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    p = RopeParams(head_dim=D, n_rot=D)
    cos, sin = rope_cos_sin(pos, p)

    perm = _rope_neox_perm(H * D, D)
    y = (x @ W.T).reshape(1, T, H, D)
    yp = (x @ W[perm].T).reshape(1, T, H, D)
    r_norm = np.asarray(apply_rope(jnp.asarray(y), cos[:, :, None], sin[:, :, None], "norm"))
    r_neox = np.asarray(apply_rope(jnp.asarray(yp), cos[:, :, None], sin[:, :, None], "neox"))
    inv = np.argsort(perm)
    np.testing.assert_allclose(
        r_neox.reshape(1, T, H * D)[..., inv], r_norm.reshape(1, T, H * D),
        rtol=1e-5, atol=1e-5,
    )
    # QK^T invariance: a shared per-head permutation of q and k leaves the
    # attention logits unchanged
    kflat = rng.standard_normal((T, H * D)).astype(np.float32)
    qk_ref = np.einsum(
        "thd,shd->hts", r_norm[0], kflat.reshape(T, H, D)
    )
    qk_perm = np.einsum(
        "thd,shd->hts", r_neox[0], kflat[:, perm].reshape(T, H, D)
    )
    np.testing.assert_allclose(qk_perm, qk_ref, rtol=1e-4, atol=1e-4)
