"""Mesh construction for TP/DP/EP/PP."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    data: int = 1,
    model: int = 1,
    expert: int = 1,
    pipe: int = 1,
    devices=None,
) -> Mesh:
    """Create a ('data', 'pipe', 'expert', 'model') mesh.

    The mesh follows the algorithm, not a physical topology: the cards of
    one host are joined all to all by NVLink, so any grouping of them is as
    good as another. Across hosts, the order keeps 'model' innermost (its
    collectives are the most frequent, so they stay inside a host), 'data'
    outermost (no per-token traffic), and 'pipe' between them — pipeline
    point-to-point traffic is light enough for the links between hosts.
    """
    devices = devices if devices is not None else jax.devices()
    n = data * pipe * expert * model
    if n > len(devices):
        raise ValueError(
            f"mesh {data}x{pipe}x{expert}x{model} needs {n} devices, have {len(devices)}"
        )
    dev = np.asarray(devices[:n]).reshape(data, pipe, expert, model)
    return Mesh(dev, ("data", "pipe", "expert", "model"))


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, 1)
