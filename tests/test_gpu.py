"""Tests that need an NVIDIA GPU: the fused kernel compiled for the card.

They skip elsewhere, deciding inside the ``gpu`` fixture (never at import).
conftest.py holds pytest to the CPU, so on the card the same checks run as
the kernel phase of chip_smoke.py, at the full widths.
"""

import pytest


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")


@pytest.mark.gpu
def test_kernel_phase_small_widths(gpu):
    """The compiled kernel against the float32 reference at a reduced
    TinyLlama width, every decode row count."""
    from chip_smoke import kernel_phase
    from kquant.models.fixtures import tiny_config

    kernel_phase([("small", tiny_config(dim=512, n_heads=8, n_kv_heads=2,
                                        ffn_dim=1024, vocab_size=1024))])


@pytest.mark.gpu
def test_auto_dispatch_takes_the_kernel_at_decode_rows(gpu):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from kquant.models.fixtures import random_qtensor
    from kquant.ops.qmatmul import qmatmul

    qt = random_qtensor("q4", 512, 1024)
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 1024), jnp.bfloat16)
    hlo = jax.jit(lambda x, q: qmatmul(x, q)).lower(x, qt).as_text()
    assert "qmm_q4" in hlo
    y = qmatmul(x, qt, out_dtype=jnp.float32)
    ref = qmatmul(x, qt, impl="xla", out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), rtol=2e-2,
                               atol=2e-2 * float(jnp.abs(ref).max()))
