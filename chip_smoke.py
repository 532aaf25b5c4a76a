#!/usr/bin/env python
"""Prove that the GGUF serving path runs on an NVIDIA GPU, end to end.

    python chip_smoke.py            # one card: kernels, then the main path
    python chip_smoke.py --four     # four cards: tensor-parallel serving only

One process, one JAX client. Phases (any failure raises and exits non-zero):

1. Device check: the card's name and power limit from nvidia-smi, JAX's
   devices. Anything but a GPU platform stops here.
2. Kernels: the fused dequant-matmul kernel compiled at the TinyLlama-1.1B
   and Llama-3-8B Q4_K_M projection widths for the decode rows it takes,
   each against a float32 reference (dequant_kmajor, then a dot at
   'highest' precision).
3. Main path, TinyLlama-1.1B Q4_K_M at full width (random weights from a
   seed): greedy generation through InferenceEngine, 12 requests through the
   ContinuousBatcher over the bf16 and the int8 KV cache, one speculative
   request against plain greedy, and the last-position prefill logits of a
   16-token prompt against an independent float64 host forward.

--four instead serves 8 requests of Llama-3-8B Q4_K_M (all widths, depth cut
to 4 layers) tensor-parallel over four cards with the int8 KV cache, and
compares logits and greedy streams with the same weights served on one card
of the same process.

The last line is the JSON result; every other figure comes before it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".cache"  # fixtures are built here once (set-up)

# kernel outputs are float32 sums of bf16 activations times exact dequantized
# weights: against the float32 reference they differ only in summation order,
# far inside the bf16 rounding of the activations that feed them (2^-8 of the
# output's scale). The bound is that bf16 scale, not float32's.
KERNEL_TOL = 1e-2
# engine logits (bf16 activations and residual stream through every layer)
# against the float64 host forward: relative L2 error of the last position
LOGIT_TOL = 5e-2
# tensor-parallel against one card: same weights, other reduction orders and
# the XLA matmul in place of the kernel; max |diff| / max |logit|
TP_TOL = 5e-2


def log(*a) -> None:
    print(*a, flush=True)


def rel_error(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"shape {got.shape} != reference {ref.shape}")
    if not np.isfinite(got).all():
        raise ValueError("non-finite values in the output")
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    return err, err / scale if scale else err


def check(name: str, got, ref, tol: float) -> float:
    """Log and enforce max |got - ref| <= tol * max |ref|."""
    err, rel = rel_error(got, ref)
    log(f"  {name}: max abs err {err:.3e}, rel {rel:.3e} (tolerance {tol:.0e})")
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {tol:.0e}")
    return rel


def top2_margin(logits) -> float:
    import numpy as np

    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def agree_or_tie(name: str, eng, prompt, a, b, tol_abs: float) -> None:
    """Greedy streams a and b of one prompt must be equal, or part first at a
    position where the engine's own logits are a near tie (top-2 margin at
    most tol_abs): there, rounding decides and both continuations are right."""
    import numpy as np

    if a == b:
        return
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    logits, _, _ = eng.prefill([list(prompt) + list(a[:i])], eng.new_cache(1))
    margin = top2_margin(np.asarray(logits[0]))
    log(f"  {name}: streams part at token {i}; top-2 margin there "
        f"{margin:.3e} (tie if <= {tol_abs:.3e})")
    if margin > tol_abs:
        raise AssertionError(f"{name}: streams differ at token {i} with a "
                             f"clear winner (margin {margin:.3e})")


def kernel_phase(configs, rows=(1, 8, 32)) -> None:
    """Compile the qmm kernel at every projection of ``configs`` for every
    decode row count and compare it with the float32 reference."""
    import jax
    import jax.numpy as jnp

    from kquant.models.fixtures import projection_shapes, random_qtensor
    from kquant.ops import qmm_triton
    from kquant.ops.qmatmul import KERNEL_MAX_ROWS
    from kquant.quant.jnp_codecs import dequant_kmajor

    for preset, cfg in configs:
        for name, kind, K, N in projection_shapes(cfg):
            qt = random_qtensor(kind, N, K, "bf16", seed=K + N)
            w = jax.jit(lambda q: dequant_kmajor(q, jnp.float32))(qt)
            for R in rows:
                if R > KERNEL_MAX_ROWS:
                    continue
                x = jax.random.normal(jax.random.PRNGKey(R), (R, K),
                                      jnp.bfloat16)
                fn = jax.jit(lambda x, q: qmm_triton.qmm_triton(
                    x, q, out_dtype=jnp.float32))
                t0 = time.perf_counter()
                compiled = fn.lower(x, qt).compile()
                dt = time.perf_counter() - t0
                log(f"{preset} {name} {kind} [{K}->{N}] rows={R} "
                    f"plan={qmm_triton.plan(kind, K, N, R)} compiled in "
                    f"{dt:.2f}s; {compiled.memory_analysis()}")
                y = compiled(x, qt)
                with jax.default_matmul_precision("highest"):
                    ref = jnp.matmul(x.astype(jnp.float32), w)
                check(f"{preset} {name} rows={R}", y, ref, KERNEL_TOL)


def fixture(name: str, cfg, seed: int) -> str:
    """The preset's GGUF under .cache/, built once from ``seed`` (set-up)."""
    from kquant.models.fixtures import write_fixture_gguf

    path = CACHE / f"{name}-rand{seed}.gguf"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        write_fixture_gguf(path, cfg, seed=seed, quant="q4_k_m",
                           random_codes=True)
        log(f"set-up: built {path.name} in {time.perf_counter() - t0:.1f}s")
    return str(path)


def mixed_requests(vocab: int, n: int, seed: int, lo: int = 8, hi: int = 300):
    import numpy as np

    from kquant.serving import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(lo, hi + 1))
        reqs.append(Request(prompt=rng.integers(10, vocab, plen).tolist(),
                            max_new_tokens=int(rng.integers(8, 33)),
                            seed=seed + i))
    return reqs


def serve(eng, reqs, mesh=None) -> dict:
    """Greedy-serve ``reqs``; each must finish with its max_new_tokens."""
    from kquant.serving import ContinuousBatcher

    cb = ContinuousBatcher(eng, seed=0, mesh=mesh)
    for r in reqs:
        cb.submit(r)
    t0 = time.perf_counter()
    done = cb.run()
    dt = time.perf_counter() - t0
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.output) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens, "
                                 f"asked for {r.max_new_tokens}")
    n = sum(len(r.output) for r in done)
    log(f"  {len(done)} requests, {n} tokens in {dt:.1f}s wall "
        f"(compiles included)")
    return {r.rid: r.output for r in done}


def main_path_phase(cfg, seed: int) -> None:
    import numpy as np

    sys.path.insert(0, str(REPO / "tests"))
    from reference_forward import ref_forward

    from kquant.quant.native import native_status
    from kquant.runtime import InferenceEngine, load_model
    from kquant.runtime.speculative import DeviceSpeculator

    path = fixture("tinyllama-1.1b-q4_k_m", cfg, seed)
    log(f"native codec library: {native_status()}")
    t0 = time.perf_counter()
    cfg, params, reader = load_model(path, scale_dtype="bf16")
    log(f"set-up: loaded {cfg.n_layers} layers, dim {cfg.dim}, vocab "
        f"{cfg.vocab_size} in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)

    log("generate: 32 greedy tokens through InferenceEngine")
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=512)
    prompt = rng.integers(10, cfg.vocab_size, 24).tolist()
    t0 = time.perf_counter()
    plain = eng.generate([prompt], max_new_tokens=32)[0]
    log(f"  {len(plain)} tokens in {time.perf_counter() - t0:.1f}s "
        f"(compiles included): {plain[:8]}...")
    if len(plain) != 32:
        raise AssertionError(f"generate returned {len(plain)} tokens")

    for kv_int8 in (False, True):
        log(f"serving: 12 requests, 8 slots, {'int8' if kv_int8 else 'bf16'}"
            f" KV cache")
        seng = InferenceEngine(cfg, params, max_batch=8, max_seq=352,
                               kv_quantized=kv_int8)
        serve(seng, mixed_requests(cfg.vocab_size, 12, seed))

    log("speculative: DeviceSpeculator (prompt-lookup draft) against plain")
    spec, stats = DeviceSpeculator(eng, None, n_draft=6).generate(
        [prompt], max_new_tokens=32)
    log(f"  {stats}")
    agree_or_tie("speculative", eng, prompt, spec[0], plain, 1e-2)

    log("logits: last prefill position of a 16-token prompt against the "
        "float64 host forward")
    toks = rng.integers(10, cfg.vocab_size, 16).tolist()
    logits, _, _ = eng.prefill([toks], eng.new_cache(1))
    got = np.asarray(logits[0], np.float64)
    t0 = time.perf_counter()
    want = ref_forward(reader, cfg, np.array(toks))[-1]
    log(f"  host forward in {time.perf_counter() - t0:.1f}s")
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    top1 = int(np.argmax(got)) == int(np.argmax(want))
    err = float(np.abs(got - want).max())
    margin = top2_margin(want)
    log(f"  relative L2 error {rel_l2:.3e} (tolerance {LOGIT_TOL:.0e}); "
        f"top-1 agrees: {top1} (reference top-2 margin {margin:.3e}, "
        f"max abs err {err:.3e})")
    if not rel_l2 <= LOGIT_TOL:
        raise AssertionError(f"logit relative L2 error {rel_l2:.3e}")
    if not top1 and margin > 2 * err:
        raise AssertionError("top-1 differs where the reference has a clear "
                             "winner")


def four_phase(cfg, seed: int) -> None:
    """Llama-3-8B widths tensor-parallel over four cards against the same
    weights on one card of this process."""
    import jax
    import numpy as np

    from kquant.parallel import make_mesh, make_param_put
    from kquant.runtime import InferenceEngine, load_model

    from kquant.quant.native import native_status

    path = fixture(f"llama3-8b-{cfg.n_layers}l-q4_k_m", cfg, seed)
    log(f"native codec library: {native_status()}")
    mesh = make_mesh(model=4)
    t0 = time.perf_counter()
    cfg4, p4, _ = load_model(path, put=make_param_put(mesh), scale_dtype="bf16")
    p1 = jax.device_put(p4, jax.devices()[0])
    log(f"set-up: loaded {cfg4.n_layers} layers sharded over "
        f"{jax.devices()[:4]} and copied to one card in "
        f"{time.perf_counter() - t0:.1f}s")
    wo = p4["layers"][0]["wo"]
    log(f"  o-projection: tp={wo.tp} fold={wo.fold}, packed codes "
        f"{wo.arrays['qs'].sharding}")
    reqs = lambda: mixed_requests(cfg4.vocab_size, 8, seed, lo=16, hi=64)
    e4 = InferenceEngine(cfg4, p4, max_batch=8, max_seq=256,
                         kv_quantized=True, mesh=mesh)
    e1 = InferenceEngine(cfg4, p1, max_batch=8, max_seq=256,
                         kv_quantized=True)
    prompts = [r.prompt for r in reqs()]
    l4, _, _ = e4.prefill(prompts, e4.new_cache(8))
    l1, _, _ = e1.prefill(prompts, e1.new_cache(8))
    rel = check("prefill logits, 8 prompts", l4, l1, TP_TOL)
    tol_abs = 2 * rel * float(np.abs(np.asarray(l1)).max())
    log("serving: 8 requests, TP=4, int8 KV cache")
    out4 = serve(e4, reqs(), mesh=mesh)
    log("serving: the same 8 requests on one card")
    out1 = serve(e1, reqs())
    for rid, pr in enumerate(prompts):
        agree_or_tie(f"request {rid}", e1, pr, out4[rid], out1[rid], tol_abs)
    same = sum(out4[r] == out1[r] for r in out1)
    log(f"  {same} of {len(out1)} greedy streams identical; the rest part "
        f"at near ties")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="tensor-parallel serving on four cards, and only that")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (REPO / "kquant").is_dir():
        sys.exit("chip_smoke.py runs from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    from kquant.utils.cache import enable_compile_cache
    from kquant.utils.device import gpu_name_power

    log(gpu_name_power())  # a child process that stays off JAX

    log(f"compile cache: {enable_compile_cache()}")
    import jax

    devices = jax.devices()
    log(f"devices: {devices}; kind {devices[0].device_kind}; "
        f"count {len(devices)}")
    if devices[0].platform != "gpu":
        sys.exit(f"no GPU: JAX runs on {devices[0].platform}")
    # compile time of each executable, as set-up (one line per compile)
    jax.config.update("jax_log_compiles", True)
    logging.getLogger("jax._src.dispatch").addFilter(
        lambda r: "XLA compilation" in r.getMessage())
    logging.getLogger("jax._src.interpreters.pxla").setLevel(logging.ERROR)

    from kquant.models.fixtures import llama3_8b_config, tinyllama_1b_config

    if args.four:
        if len(devices) < 4:
            sys.exit(f"--four needs 4 cards, JAX sees {len(devices)}")
        # all widths of Llama-3-8B, depth cut to 4 of its 32 layers: the
        # comparison is per layer, and every layer is sharded alike
        four_phase(dataclasses.replace(llama3_8b_config(), n_layers=4),
                   args.seed)
    else:
        kernel_phase([("tinyllama", tinyllama_1b_config()),
                      ("llama3-8b", llama3_8b_config())])
        main_path_phase(tinyllama_1b_config(), args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
