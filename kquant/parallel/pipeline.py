"""Pipeline parallelism: GPipe-style stage-sharded layers over a 'pipe' mesh axis.

The reference has no pipeline parallelism (SURVEY.md 2.2: PP absent — its
JAX equivalent is "layer-stage sharding via shard_map + collective
permute"); this module provides it for 70B-class models whose layer stack
does not fit (or does not scale) on one TP group.

Design (idiomatic JAX, not a port of any GPU PP runtime):

- Layers are STACKED along a leading axis (models.llama.stack_layer_params)
  and that axis is sharded over 'pipe': each stage owns n_layers/n_pipe
  contiguous layers and lax.scans over them.
- Only 'pipe' is a *manual* shard_map axis; 'model'/'data'/'expert' stay in
  GSPMD auto mode, so tensor-parallel collectives inside a stage are still
  inserted by XLA (PP composes with TP/EP without any extra code here).
- Schedule: GPipe over M microbatches (batch-axis chunks). Step t has stage r
  working on microbatch t-r; activations hop stage->stage+1 via
  lax.ppermute, KV-cache writes are masked out for bubble steps. M=1
  degenerates to a sequential stage relay (the decode case, B small).
- Embedding and the lm_head run replicated outside the shard_map (they are
  cheap and already TP-sharded by GSPMD); the last stage's hidden states are
  replicated back with a masked psum over 'pipe'.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kquant.models.config import ModelConfig
from kquant.models.llama import llama_layer
from kquant.ops import qmatmul, rms_norm, rope_cos_sin
from kquant.quant.jnp_codecs import dequant_rows
from kquant.runtime.kv_cache import KVCache


def stack_pp_params(params: dict[str, Any], mesh: Mesh) -> dict[str, Any]:
    """Stack per-layer params and shard the new layer axis over 'pipe'.

    Per-leaf TP specs already applied by the loader's put (parallel.sharding)
    are preserved, shifted right by the new leading axis."""
    layers = params["layers"]
    n_pipe = mesh.shape["pipe"]
    if len(layers) % n_pipe != 0:
        raise ValueError(f"n_layers {len(layers)} not divisible by pipe {n_pipe}")
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    flat0, treedef = jax.tree.flatten(layers[0])
    flat_stacked = jax.tree.leaves(stacked)
    out_leaves = []
    for x0, xs in zip(flat0, flat_stacked):
        spec: tuple = ()
        if isinstance(getattr(x0, "sharding", None), NamedSharding):
            spec = tuple(x0.sharding.spec)
        spec = spec + (None,) * (xs.ndim - 1 - len(spec))
        out_leaves.append(jax.device_put(xs, NamedSharding(mesh, P("pipe", *spec))))
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers_stacked"] = jax.tree.unflatten(treedef, out_leaves)
    return out


def shard_cache_pp(cache: KVCache, mesh: Mesh) -> KVCache:
    """Shard a KVCache for PP: layer axis over 'pipe', batch over 'data',
    kv heads over 'model'."""
    shp = mesh.shape

    def put(x):
        if x is None:
            return None
        spec = [None] * x.ndim  # [L, B, Hkv, S(, D)]
        if shp["pipe"] > 1 and x.shape[0] % shp["pipe"] == 0:
            spec[0] = "pipe"
        if shp["data"] > 1 and x.shape[1] % shp["data"] == 0:
            spec[1] = "data"
        if shp["model"] > 1 and x.shape[2] % shp["model"] == 0:
            spec[2] = "model"
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return KVCache(put(cache.k), put(cache.v), put(cache.k_scale), put(cache.v_scale))


def make_pp_forward(mesh: Mesh, n_micro: int = 1):
    """Build a drop-in replacement for models.llama.llama_forward that runs
    the layer stack pipeline-parallel over mesh axis 'pipe' with ``n_micro``
    GPipe microbatches (batch must divide by n_micro; otherwise falls back
    to a single microbatch)."""
    pp_mesh = mesh  # the forward's own `mesh` kwarg must not shadow this
    n_pipe = pp_mesh.shape["pipe"]

    def forward(
        params: dict[str, Any],
        cfg: ModelConfig,
        tokens: jnp.ndarray,  # [B, T]
        positions: jnp.ndarray,  # [B, T]
        cache: KVCache,
        impl: str = "auto",
        logits_last_only: bool = False,
        act_dtype=jnp.bfloat16,
        mesh: Mesh | None = None,  # accepted for signature parity; a2a MoE
        # inside a PP stage would nest manual shard_maps — unsupported, the
        # dense 'ep' path composes with PP instead
    ):
        x = dequant_rows(params["tok_embd"], tokens, dtype=act_dtype)
        cos, sin = rope_cos_sin(positions, cfg.rope)
        cos, sin = cos.astype(jnp.float32), sin.astype(jnp.float32)
        B = x.shape[0]
        M = n_micro if (n_micro <= B and B % n_micro == 0) else 1
        layers = params["layers_stacked"]
        ckv = (cache.k, cache.v, cache.k_scale, cache.v_scale)

        def stages(layers_loc, ckv_loc, x_all, pos_all, cos_all, sin_all):
            r = lax.axis_index("pipe")
            MB = x_all.shape[0] // M
            outputs = jnp.zeros_like(x_all)
            recv = jnp.zeros((MB,) + x_all.shape[1:], x_all.dtype)
            k, v, ks, vs = ckv_loc

            for t in range(M + n_pipe - 1):
                mb = t - r  # stage r works on microbatch t-r at step t
                valid = (mb >= 0) & (mb < M)
                b0 = jnp.clip(mb, 0, M - 1) * MB
                x_in = jnp.where(
                    r == 0, lax.dynamic_slice_in_dim(x_all, b0, MB, 0), recv
                )
                pos_mb = lax.dynamic_slice_in_dim(pos_all, b0, MB, 0)
                cos_mb = lax.dynamic_slice_in_dim(cos_all, b0, MB, 0)
                sin_mb = lax.dynamic_slice_in_dim(sin_all, b0, MB, 0)

                def sl(a):
                    return None if a is None else lax.dynamic_slice_in_dim(a, b0, MB, 1)

                lkv_mb = (sl(k), sl(v), sl(ks), sl(vs))

                def scan_body(xc, xs):
                    layer, lkv = xs
                    xc, lkv = llama_layer(
                        layer, cfg, xc, pos_mb, cos_mb, sin_mb, lkv, impl
                    )
                    return xc, lkv

                x_out, lkv_new = lax.scan(scan_body, x_in, (layers_loc, lkv_mb))

                def wb(a, old, new):  # bubble steps must not touch the cache
                    if a is None:
                        return None
                    return lax.dynamic_update_slice_in_dim(
                        a, jnp.where(valid, new, old), b0, 1
                    )

                k = wb(k, lkv_mb[0], lkv_new[0])
                v = wb(v, lkv_mb[1], lkv_new[1])
                ks = wb(ks, lkv_mb[2], lkv_new[2])
                vs = wb(vs, lkv_mb[3], lkv_new[3])
                out_mb = jnp.where(
                    valid & (r == n_pipe - 1),
                    x_out,
                    lax.dynamic_slice_in_dim(outputs, b0, MB, 0),
                )
                outputs = lax.dynamic_update_slice_in_dim(outputs, out_mb, b0, 0)
                if n_pipe > 1:
                    recv = lax.ppermute(
                        x_out, "pipe", [(i, i + 1) for i in range(n_pipe - 1)]
                    )
            # only the last stage holds real outputs (zeros elsewhere):
            # the psum replicates them to every stage. psum in f32: bf16
            # all-reduce inside a partially-manual shard_map crashes XLA CPU's
            # float-normalization pass ("Invalid binary instruction opcode
            # copy"), and f32 accumulation is what we want anyway.
            if n_pipe > 1:
                outputs = lax.psum(
                    outputs.astype(jnp.float32), "pipe"
                ).astype(outputs.dtype)
            return outputs, (k, v, ks, vs)

        pipe_spec = lambda tree: jax.tree.map(lambda _: P("pipe"), tree)
        outputs, ckv = jax.shard_map(
            stages,
            mesh=pp_mesh,
            in_specs=(pipe_spec(layers), pipe_spec(ckv), P(), P(), P(), P()),
            out_specs=(P(), pipe_spec(ckv)),
            axis_names=frozenset({"pipe"}),
        )(layers, ckv, x, positions, cos, sin)
        cache = KVCache(*ckv)

        x = rms_norm(outputs, params["output_norm"].arrays["w"], cfg.norm_eps)
        if logits_last_only:
            x = x[:, -1:, :]
        logits = qmatmul(x, params["output"], impl, out_dtype=jnp.float32)
        return logits, cache

    return forward
