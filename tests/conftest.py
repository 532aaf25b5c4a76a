"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators, the standard JAX
pattern (SURVEY.md section 4: test strategy item (e)). The CPU backend is
forced both by the environment variable and by a config update after import,
so that an installed GPU plugin cannot take over. Tests that need a GPU
carry the ``gpu`` marker and skip here (tests/test_gpu.py).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8, jax.devices()
