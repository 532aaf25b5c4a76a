"""GGUF requantization tool — the llama-quantize equivalent.

Reads any GGUF, re-encodes weight tensors per a target recipe, writes a new
GGUF. Norm vectors stay F32; the Q4_K_M recipe reproduces llama.cpp's mixed
assignment (attn_v / ffn_down / output at Q6_K — the reason the reference's
lm-head dot is ggml_vec_dot_q6_K_q8_K, SURVEY.md 3.1).

  python -m kquant.tools.quantize --in f16.gguf --out q4.gguf --type q4_k_m
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from kquant.gguf import GGMLType, GGUFReader, GGUFWriter
from kquant.quant import dequantize, quantize

RECIPES = {
    "q4_k_m": None,  # mixed; see _target_type
    "q4_k_s": None,
    "q8_0": GGMLType.Q8_0,
    "q6_k": GGMLType.Q6_K,
    "q5_k_m": None,
    "q3_k_m": None,  # mixed: Q3_K base, Q4_K/Q5_K bumps (llama.cpp-style)
    "q2_k": None,    # mixed: Q2_K base, Q4_K attn_v (llama.cpp's Q2_K)
    "f16": GGMLType.F16,
    "bf16": GGMLType.BF16,
}


def _target_type(name: str, shape, recipe: str) -> GGMLType:
    if name.endswith("_norm.weight") or len(shape) == 1:
        return GGMLType.F32
    uniform = RECIPES.get(recipe)
    if uniform is not None:
        t = uniform
    elif recipe == "q2_k":
        # llama.cpp's Q2_K recipe: Q2_K base, attn_v/output bumped
        t = GGMLType.Q2_K
        if "attn_v" in name:
            t = GGMLType.Q4_K
        elif "output.weight" in name:
            t = GGMLType.Q6_K
    elif recipe == "q3_k_m":
        t = GGMLType.Q3_K
        if any(s in name for s in ("attn_v", "ffn_down", "attn_output")):
            t = GGMLType.Q4_K
        elif "output.weight" in name:
            t = GGMLType.Q5_K
    else:
        base = GGMLType.Q5_K if recipe == "q5_k_m" else GGMLType.Q4_K
        t = base
        if recipe.endswith("_m") and any(
            s in name for s in ("attn_v", "ffn_down", "output.weight")
        ):
            t = GGMLType.Q6_K
    # block-size feasibility fallbacks
    from kquant.gguf.constants import block_size

    if shape[-1] % block_size(t) != 0:
        if shape[-1] % 32 == 0:
            return GGMLType.Q8_0
        return GGMLType.F16
    return t


def requantize(in_path: str, out_path: str, recipe: str = "q4_k_m",
               verbose: bool = True) -> dict:
    r = GGUFReader(in_path)
    w = GGUFWriter(out_path)
    for k, v in r.metadata.items():
        if k == "general.file_type":
            continue
        w.add(k, v)
    stats = {"tensors": 0, "bytes_in": 0, "bytes_out": 0}
    for name, ti in r.tensors.items():
        t0 = time.time()
        target = _target_type(name, ti.shape, recipe)
        if target == ti.ggml_type:
            raw = np.asarray(r.tensor_bytes(name))
        else:
            f32 = dequantize(r.tensor_bytes(name), ti.ggml_type, ti.shape)
            raw = quantize(f32, target)
        w.add_tensor(name, np.empty(ti.shape, np.float32), target, raw=raw)
        stats["tensors"] += 1
        stats["bytes_in"] += ti.n_bytes
        stats["bytes_out"] += raw.size
        if verbose:
            print(f"  {name}: {ti.ggml_type.name} -> {target.name} "
                  f"({raw.size / 1e6:.1f} MB, {time.time() - t0:.2f}s)",
                  file=sys.stderr)
    w.write()
    r.close()
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description="requantize a GGUF model")
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--type", default="q4_k_m", choices=sorted(RECIPES))
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    s = requantize(args.inp, args.out, args.type, verbose=not args.quiet)
    print(f"{s['tensors']} tensors: {s['bytes_in']/1e6:.1f} MB -> "
          f"{s['bytes_out']/1e6:.1f} MB ({args.type})")


if __name__ == "__main__":
    main()
