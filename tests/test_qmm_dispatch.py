"""Quantized matmul around the kernel: the XLA path against a NumPy
dequantization for every kind, the fused kernel (Pallas interpreter) at
widths that need padding and split-K, the kernel's launch plan, and the
backend registry that decides which one runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kquant.gguf.constants import GGMLType
from kquant.models.fixtures import (llama3_8b_config, projection_shapes,
                                    random_qtensor, tinyllama_1b_config)
from kquant.ops import qmm_triton
from kquant.ops.qmatmul import KERNEL_MAX_ROWS, kernel_takes, qmatmul
from kquant.ops.registry import KERNELS, kernel_for
from kquant.quant import quantize
from kquant.quant.numpy_codecs import dequantize
from kquant.quant.qtensor import QTensor
from kquant.quant.repack import (pack_scale_kpairs, pack_scale_pairs, repack,
                                 widen_q6)

QTYPES = {
    "q2": GGMLType.Q2_K, "q3": GGMLType.Q3_K, "q4": GGMLType.Q4_K,
    "q5": GGMLType.Q5_K, "q6": GGMLType.Q6_K, "q8": GGMLType.Q8_0,
    "q4_0": GGMLType.Q4_0,
}


def _weight(name, N=96, K=512, seed=0):
    """(QTensor on device, float64 W [N, K] it encodes)."""
    rng = np.random.default_rng(seed)
    base = "q6" if name.startswith("q6") else name.split("+")[0]
    t = QTYPES[base]
    raw = quantize(rng.standard_normal((N, K)).astype(np.float32) * 0.1, t)
    w = dequantize(raw, t, (N, K)).astype(np.float64)
    qt = repack(raw, t, (N, K), layout="kmajor")
    if name.startswith("q6w"):
        qt = widen_q6(qt)
    if name.endswith("+sm"):
        qt = pack_scale_pairs(qt)
    if name.endswith("+sp"):
        qt = pack_scale_kpairs(qt)
    return QTensor(qt.kind, qt.layout, qt.shape,
                   {k: jnp.asarray(v) for k, v in qt.arrays.items()}), w


KINDS = ["q2", "q3", "q4", "q5", "q6", "q8", "q4_0", "q6w", "q4+sm", "q6w+sp"]


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_xla_path_matches_numpy(name, dtype):
    qt, w = _weight(name, seed=len(name))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((3, 512)), dtype)
    got = np.asarray(qmatmul(x, qt, impl="xla", out_dtype=jnp.float32))
    want = np.asarray(x, np.float64) @ w.T
    # bf16 pairs store scales in bf16; bf16 activations run a bf16 matmul
    rel = 1e-5 if dtype == jnp.float32 and "+" not in name else 2e-2
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kind,N,K,R,split", [
    ("q4", 200, 512, 3, None),     # N not a multiple of the slab: masked
    ("q4", 96, 1024, 17, 4),       # two 16-row blocks, the second padded
    ("q4", 128, 2048, 1, 16),      # split-K down to 2 chunks per program
    ("q6w", 40, 512, 1, 2),        # a 32-wide slab, partly masked
    ("q6w", 256, 1024, 33, 8),     # two row blocks, the second one padded
    ("q5", 64, 512, 5, 1),         # one program walks all of K
    ("q3", 64, 1024, 2, 4),
    ("q8", 128, 256, 9, None),
])
def test_kernel_padding_and_split(kind, N, K, R, split):
    name = {"q6w": "q6w", "q8": "q8"}.get(kind, kind)
    qt, w = _weight(name, N=N, K=K, seed=N + R)
    x = jnp.asarray(np.random.default_rng(R).standard_normal((R, K)),
                    jnp.bfloat16)
    got = qmm_triton.qmm_triton(x, qt, out_dtype=jnp.float32, interpret=True,
                                split=split)
    want = np.asarray(x, np.float64) @ w.T
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_kernel_rejects_split_that_does_not_divide():
    qt, _ = _weight("q4", N=64, K=512)
    with pytest.raises(ValueError, match="split"):
        qmm_triton.qmm_triton(jnp.ones((1, 512), jnp.bfloat16), qt,
                              interpret=True, split=3)


@pytest.mark.parametrize("preset", ["tiny", "8b"])
def test_plan_at_real_widths(preset):
    """Every projection of both presets: power-of-two slabs no wider than N,
    a split that divides the K chunks, row blocks of 16+ for the dot path."""
    cfg = {"tiny": tinyllama_1b_config, "8b": llama3_8b_config}[preset]()
    for name, kind, K, N in projection_shapes(cfg):
        assert qmm_triton.supported(kind, K, N), name
        for R in (1, 8, 32, 512):
            bn, split, br = qmm_triton.plan(kind, K, N, R)
            assert bn & (bn - 1) == 0 and 16 <= bn <= min(N, 128)
            _, fold, _ = qmm_triton.LAYOUTS[kind]
            chunks = K // fold // qmm_triton.GROUP_SIZE[kind]
            assert chunks % split == 0 and chunks // split >= 4
            assert br == 1 if R == 1 else (br >= 16 and br & (br - 1) == 0)


def test_supported_shapes():
    assert qmm_triton.supported("q4", 2048, 2304)
    assert not qmm_triton.supported("q4", 2048 + 32, 128)  # folds straddle
    assert not qmm_triton.supported("q4", 2048, 8)          # narrower than 16
    assert not qmm_triton.supported("dense", 2048, 128)


def test_projection_shapes_tinyllama():
    shapes = {n: (k, K, N) for n, k, K, N in
              projection_shapes(tinyllama_1b_config())}
    assert shapes["qk"] == ("q4", 2048, 2304)
    assert shapes["down"] == ("q6w", 5632, 2048)
    assert shapes["lm_head"] == ("q6w", 2048, 32000)


@pytest.mark.parametrize("kind,scales,keys", [
    ("q4", "bf16", {"qs", "sm"}), ("q4", "f32", {"qs", "scales", "mins"}),
    ("q6w", "bf16", {"qs", "sp"}), ("q6w", "f32", {"qs", "scales"}),
])
def test_random_qtensor_layouts(kind, scales, keys):
    qt = random_qtensor(kind, 48, 512, scales)
    assert set(qt.arrays) == keys
    assert qt.arrays["qs"].shape == ((256, 48) if kind == "q4" else (512, 48))


# -- registry --------------------------------------------------------------


def test_registry_xla_is_never_a_kernel():
    assert kernel_for("qmm", "xla") is None
    assert kernel_for("attention", "xla") is None


def test_registry_auto_on_cpu_runs_xla():
    assert jax.default_backend() == "cpu"
    assert kernel_for("qmm", "auto") is None
    assert kernel_for("attention", "auto") is None


def test_registry_kernel_request_without_kernel_raises():
    with pytest.raises(NotImplementedError, match="cpu"):
        kernel_for("qmm", "pallas")


def test_registry_interpret_is_explicit():
    assert kernel_for("qmm", "auto", interpret=True) == KERNELS["qmm"]["gpu"]
    with pytest.raises(NotImplementedError):
        kernel_for("attention", "pallas", interpret=True)


def test_registry_rejects_unknown_impl():
    with pytest.raises(ValueError):
        kernel_for("qmm", "int8")


def test_qmatmul_auto_on_cpu_equals_xla():
    qt, _ = _weight("q4+sm", N=64, K=512)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 512)),
                    jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(qmatmul(x, qt)),
                                  np.asarray(qmatmul(x, qt, impl="xla")))


def test_qmatmul_kernel_request_on_cpu_raises():
    qt, _ = _weight("q4", N=64, K=512)
    with pytest.raises(NotImplementedError):
        qmatmul(jnp.ones((1, 512), jnp.bfloat16), qt, impl="pallas")


def test_qmatmul_interpret_routes_to_kernel():
    qt, w = _weight("q6w+sp", N=64, K=512)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((2, 512)),
                    jnp.bfloat16)
    got = qmatmul(x, qt, out_dtype=jnp.float32, interpret=True)
    want = np.asarray(x, np.float64) @ w.T
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("change,takes", [
    ({}, True),
    ({"tp": "col"}, False),   # sharded weights stay on the XLA path
    ({"fold": 2}, False),     # block-local fold of row-parallel shards
    ({"shape": (2, 64, 512)}, False),  # stacked experts
])
def test_kernel_takes(change, takes):
    qt, _ = _weight("q4", N=64, K=512)
    fields = dict(kind=qt.kind, layout=qt.layout, shape=qt.shape,
                  arrays=qt.arrays)
    fields.update(change)
    assert kernel_takes(jnp.ones((1, 512), jnp.bfloat16),
                        QTensor(**fields)) is takes


def test_kernel_max_rows_is_decode():
    assert 8 <= KERNEL_MAX_ROWS < 512
