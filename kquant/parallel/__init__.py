"""Parallelism layer: device meshes + GSPMD sharding specs for packed weights.

The reference has NO cross-device parallelism (SURVEY.md 2.2: thread-level
intra-op only; 2.3: no distributed backend). This package supplies the
JAX replacements: tensor/data/expert sharding of QTensors over a
jax.sharding.Mesh, with XLA inserting ICI/DCN collectives.
"""

from kquant.parallel.mesh import make_mesh  # noqa: F401
from kquant.parallel.pipeline import (  # noqa: F401
    make_pp_forward,
    shard_cache_pp,
    stack_pp_params,
)
from kquant.parallel.sharding import (  # noqa: F401
    make_param_put,
    shard_cache,
    shard_qtensor,
    shard_random_params,
)
