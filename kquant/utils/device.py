"""What the program runs on: the device as JAX reports it and the card's
name and power limit as the driver reports them."""

from __future__ import annotations

import shutil
import subprocess


def gpu_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one per
    line; 'not available' where there is no nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return "not available"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def describe() -> dict:
    """platform, device_kind and count of JAX's devices, plus the cards."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "cards": gpu_name_power()}
