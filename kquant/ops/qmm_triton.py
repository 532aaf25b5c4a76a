"""Fused dequant + matmul for Hopper: Pallas on the Triton route.

y[r, n] = sum_k x[r, k] * (scales[k // g, n] * q[k, n] - mins[k // g, n])

The packed weight is read once, in its folded-K layout (quant/repack.py): a
byte row r of ``qs`` carries the codes of logical rows r, r + K/f, ... for a
fold of f codes per byte. Each program owns a BLOCK_N column slab and walks
its share of the packed rows in a loop, one scale group per chunk: it loads
the chunk's bytes once and unpacks every fold of them in registers. Because a
chunk is exactly one scale group, the scale multiplies the chunk's partial
dot after the contraction and the mins enter as ``xsum[r, grp] * min[n]``
with the per-group activation sums computed outside the kernel.

Split-K: the packed rows are cut into ``split`` ranges, one per program along
grid axis 1, so that narrow projections still put enough programs in flight
to fill the card. The partial sums land in a [split, R, N] float32 array that
XLA reduces. One row (single-stream decode) takes a multiply-accumulate path;
more rows take ``pl.dot`` on row blocks padded to 16.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from kquant.quant.qtensor import QTensor
from kquant.quant.repack import GROUP_SIZE

# kind -> (bits per code in qs, codes per qs byte, high-bit planes). A plane
# (array, codes per byte, bits, position) ORs its bits in above the base code.
LAYOUTS = {
    "q4": (4, 2, ()),
    "q5": (4, 2, (("qh", 8, 1, 4),)),
    "q6": (4, 2, (("qh", 4, 2, 4),)),
    "q2": (2, 4, ()),
    "q3": (2, 4, (("qh", 8, 1, 2),)),
    "q8": (8, 1, ()),
    "q6w": (8, 1, ()),
}

_HI16 = -65536  # int32 0xFFFF0000


def supported(kind: str, K: int, N: int) -> bool:
    """Shapes the kernel takes: every fold's chunks stay inside one group."""
    if kind not in LAYOUTS or N < 16:
        return False
    _, fold, planes = LAYOUTS[kind]
    need = GROUP_SIZE[kind] * max([fold] + [p[1] for p in planes])
    return K % need == 0


def _bf16_half(bits, high):
    """One bf16 of an f32-container pair, widened to f32."""
    half = (bits & _HI16) if high else (bits << 16)
    return jax.lax.bitcast_convert_type(half, jnp.float32)


def _kernel(*refs, kind, K, g, fmt, has_mins, has_xs, BR, BN, chunks):
    """One (column slab, K range, row block) of the partial sums."""
    bits, fold, planes = LAYOUTS[kind]
    names = ["x"] + (["xs"] if has_xs else []) + ["qs"] + [p[0] for p in planes]
    names += {"sm": ["sm"], "sp": ["sp"], "scales": ["scales"]}[fmt]
    if fmt == "scales" and has_mins:
        names.append("mins")
    r = dict(zip(names, refs))
    o_ref = refs[len(names)]
    R, N = r["x"].shape[0], r["qs"].shape[1]

    n0 = pl.program_id(0) * BN
    split = pl.program_id(1)
    r0 = pl.program_id(2) * BR
    cols = n0 + jnp.arange(BN)
    cmask = cols < N
    rows = r0 + jnp.arange(BR)
    rmask = rows < R
    kf = K // fold  # packed rows of qs
    vec = BR == 1

    def load_w(ref, row):
        return plgpu.load(ref.at[pl.ds(row, g), pl.ds(n0, BN)],
                          mask=cmask[None, :], other=0)

    def load_row(ref, row):
        return plgpu.load(ref.at[row, pl.ds(n0, BN)], mask=cmask, other=0)

    def scale_min(grp):
        if fmt == "sm":
            b = jax.lax.bitcast_convert_type(load_row(r["sm"], grp), jnp.int32)
            return _bf16_half(b, False), _bf16_half(b, True)
        if fmt == "sp":
            b = jax.lax.bitcast_convert_type(load_row(r["sp"], grp // 2),
                                             jnp.int32)
            s = (b << ((1 - grp % 2) * 16)) & _HI16  # odd groups: high half
            return jax.lax.bitcast_convert_type(s, jnp.float32), None
        s = load_row(r["scales"], grp).astype(jnp.float32)
        m = load_row(r["mins"], grp).astype(jnp.float32) if has_mins else None
        return s, m

    def body(c, acc):
        p0 = (split * chunks + c) * g  # first packed row of this chunk
        qs = load_w(r["qs"], p0)
        if fold > 1:
            qs = qs.astype(jnp.int32)
        his = []
        for name, hfold, _, _ in planes:
            hk = K // hfold
            his.append((load_w(r[name], p0 % hk).astype(jnp.int32), p0 // hk))
        for j in range(fold):
            k0 = p0 + j * kf
            grp = k0 // g
            if fold > 1:
                q = (qs >> (bits * j)) & ((1 << bits) - 1)
            else:
                q = qs
            for (_, hfold, hbits, pos), (h, hblk) in zip(planes, his):
                sh = hbits * (hblk + j * (hfold // fold))
                q = q | (((h >> sh) & ((1 << hbits) - 1)) << pos)
            s, m = scale_min(grp)
            if vec:  # one row: dequantize and multiply-accumulate
                w = q.astype(jnp.float32) * s[None, :]
                if m is not None:
                    w = w - m[None, :]
                xk = plgpu.load(r["x"].at[0, pl.ds(k0, g)]).astype(jnp.float32)
                acc = acc + xk[:, None] * w
                continue
            xk = plgpu.load(r["x"].at[pl.ds(r0, BR), pl.ds(k0, g)],
                            mask=rmask[:, None], other=0)
            d = pl.dot(xk, q.astype(jnp.bfloat16))
            acc = acc + d * s[None, :]
            if m is not None:
                xsum = plgpu.load(r["xs"].at[pl.ds(r0, BR), grp],
                                  mask=rmask, other=0)
                acc = acc - xsum[:, None] * m[None, :]
        return acc

    acc = jnp.zeros((g if vec else BR, BN), jnp.float32)
    acc = jax.lax.fori_loop(0, chunks, body, acc)
    if vec:
        y = jnp.sum(acc, axis=0)
        plgpu.store(o_ref.at[split, 0, pl.ds(n0, BN)], y, mask=cmask)
    else:
        plgpu.store(o_ref.at[split, pl.ds(r0, BR), pl.ds(n0, BN)], acc,
                    mask=rmask[:, None] & cmask[None, :])


def _pow2_at_most(v: int, cap: int) -> int:
    p = 1
    while p * 2 <= min(v, cap):
        p *= 2
    return p


def plan(kind: str, K: int, N: int, R: int, sms: int = 132):
    """(BLOCK_N, split, BLOCK_R). Column slabs of 128, or of 32 for one row
    against N <= 2560, where more and smaller programs measured faster on
    the H100; then split-K until about four programs per SM are in flight,
    keeping at least 4 chunks per program."""
    _, fold, _ = LAYOUTS[kind]
    bn = _pow2_at_most(N, 32 if R == 1 and N <= 2560 else 128)
    br = 1 if R == 1 else max(16, _pow2_at_most(R, 64))
    blocks = pl.cdiv(N, bn) * pl.cdiv(R, br)
    n_chunks = K // fold // GROUP_SIZE[kind]
    split = 1
    while (blocks * split < 4 * sms and n_chunks % (split * 2) == 0
           and n_chunks // (split * 2) >= 4):
        split *= 2
    return bn, split, br


@functools.partial(jax.jit, static_argnames=(
    "kind", "K", "keys", "out_dtype", "interpret", "bn", "split", "br"))
def _call(x2d, arrays, *, kind, K, keys, out_dtype, interpret, bn, split, br):
    a = dict(zip(keys, arrays))
    g = GROUP_SIZE[kind]
    R = x2d.shape[0]
    N = a["qs"].shape[1]
    _, fold, planes = LAYOUTS[kind]
    fmt = "sm" if "sm" in a else ("sp" if "sp" in a else "scales")
    has_mins = fmt == "sm" or "mins" in a
    x = x2d.astype(jnp.bfloat16)
    inputs = [x]
    has_xs = has_mins and br > 1  # the dot path subtracts mins per group
    if has_xs:
        inputs.append(x.astype(jnp.float32).reshape(R, K // g, g).sum(-1))
    inputs.append(a["qs"])
    inputs += [a[p[0]] for p in planes]
    inputs.append(a[fmt])
    if fmt == "scales" and has_mins:
        inputs.append(a["mins"])
    if (K // fold // g) % split:
        raise ValueError(f"split {split} does not divide the "
                         f"{K // fold // g} chunks of K={K}")
    chunks = K // fold // g // split
    kernel = functools.partial(
        _kernel, kind=kind, K=K, g=g, fmt=fmt, has_mins=has_mins,
        has_xs=has_xs, BR=br, BN=bn, chunks=chunks)
    part = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(N, bn), split, pl.cdiv(R, br)),
        out_shape=jax.ShapeDtypeStruct((split, R, N), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        backend="triton",
        interpret=interpret,
        name=f"qmm_{kind}",
    )(*inputs)
    return part.sum(0).astype(out_dtype)


def qmm_triton(x: jnp.ndarray, qt: QTensor, out_dtype=None,
               interpret: bool = False, bn: int | None = None,
               split: int | None = None) -> jnp.ndarray:
    """Fused y = x @ dequant(W)^T for a kmajor QTensor with the global fold.

    x: [..., K]; returns [..., N]. ``bn`` and ``split`` override the plan."""
    if qt.layout != "kmajor" or (qt.fold or 1) > 1 or len(qt.shape) != 2:
        raise ValueError(f"qmm_triton takes a 2-D kmajor tensor with the "
                         f"global fold, got {qt.layout} fold={qt.fold}")
    N, K = qt.shape
    if not supported(qt.kind, K, N):
        raise ValueError(f"qmm_triton does not take {qt.kind} at K={K} N={N}")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, K)
    pbn, psplit, br = plan(qt.kind, K, N, x2d.shape[0])
    keys = tuple(sorted(qt.arrays))
    y = _call(x2d, tuple(qt.arrays[k] for k in keys), kind=qt.kind, K=K,
              keys=keys, out_dtype=jnp.dtype(out_dtype or x.dtype).name,
              interpret=interpret, bn=bn or pbn, split=split or psplit,
              br=br)
    return y.reshape(*lead, N)
