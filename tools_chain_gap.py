#!/usr/bin/env python
"""Interval analysis of the fused decode loop's DEVICE timeline: where does
the in-chain step time actually go?

The per-op table (tools_trace_decode.py) sums op SPANS, which double-counts
the enclosing while and the async copy-start..copy-done windows. This tool
instead works on the timeline: take the window (the while op's span where
the device records one, else first to last event), bucket every kernel in it
by family, compute the union-of-intervals occupancy per family, and report
the IDLE gaps (time when no kernel is running) — the launch and host
overhead between kernels.

  python tools_chain_gap.py .cache/trace_decode.xplane.pb --steps 32
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from kquant.utils.xplane import parse_xspace


def family(name: str) -> str:
    """Map an HLO op name to a reporting family."""
    head = name.split(" = ")[0].lstrip("%")
    if name.startswith("%while"):
        return "while-wrapper"
    if "custom-call" in name:
        m = re.match(r"([a-zA-Z_]+)", head)
        return f"cc:{m.group(1) if m else head}"
    if head.startswith(("copy-start", "copy-done", "copy.")):
        return "copy"
    if head.startswith(("slice-start", "slice-done")):
        return "async-slice"
    if "dynamic-update-slice" in name or head.startswith("dynamic_update"):
        return "dus"
    if "fusion" in head:
        m = re.match(r"([a-zA-Z_]+)", head)
        return f"fusion:{m.group(1) if m else head}"
    m = re.match(r"([a-zA-Z-]+)", head)
    return m.group(1) if m else head


def union_us(iv: list[tuple[int, int]]) -> float:
    if not iv:
        return 0.0
    iv.sort()
    tot = 0
    cs, ce = iv[0]
    for s, e in iv[1:]:
        if s > ce:
            tot += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    tot += ce - cs
    return tot / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("xplane")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--top", type=int, default=24)
    ap.add_argument("--gaps", type=int, default=12,
                    help="print the N largest idle gaps")
    args = ap.parse_args()

    planes = parse_xspace(args.xplane)
    events = []
    for pname, lines in planes:
        if not pname.startswith("/device:GPU"):
            continue
        for lname, evs in lines:
            if not lname.startswith("Stream"):
                continue
            events.extend(evs)
    if not events:
        sys.exit("no stream line on a GPU device plane")

    # the enclosing while = the longest while-family event
    whiles = [(n, o, d) for n, o, d in events if n.startswith("%while")]
    if whiles:
        wname, w0, wd = max(whiles, key=lambda e: e[2])
        w1 = w0 + wd
        print(f"while span: {wd/1e6:.1f} us  ({wd/1e6/args.steps:.1f}/step)")
    else:
        w0 = min(o for _, o, _ in events)
        w1 = max(o + d for _, o, d in events)
        print(f"no while op; using full extent {(w1-w0)/1e6:.1f} us")

    inside = [(n, o, d) for n, o, d in events
              if o >= w0 and o + d <= w1 and not n.startswith("%while")]

    fam_iv: dict[str, list] = defaultdict(list)
    fam_sum: dict[str, float] = defaultdict(float)
    fam_cnt: dict[str, int] = defaultdict(int)
    compute_iv = []
    for n, o, d in inside:
        f = family(n)
        fam_iv[f].append((o, o + d))
        fam_sum[f] += d / 1e6
        fam_cnt[f] += 1
        # async windows span their wait; they don't occupy the core
        if f not in ("copy", "async-slice"):
            compute_iv.append((o, o + d))

    print(f"\n{'family':<34}{'sum us':>10}{'union us':>10}{'/step':>9}{'count':>8}")
    rows = sorted(fam_iv.items(), key=lambda kv: -union_us(list(kv[1])))
    for f, iv in rows[: args.top]:
        u = union_us(list(iv))
        print(f"{f:<34}{fam_sum[f]:>10.1f}{u:>10.1f}{u/args.steps:>9.2f}"
              f"{fam_cnt[f]:>8}")

    # idle: while span minus union of compute events
    compute_iv.sort()
    busy = union_us(list(compute_iv))
    span = (w1 - w0) / 1e6
    print(f"\ncompute busy {busy:.1f} us of {span:.1f} span "
          f"-> idle {span - busy:.1f} us ({(span-busy)/args.steps:.1f}/step, "
          f"{100*(span-busy)/span:.1f}%)")

    # largest gaps with neighbours
    evs = sorted(((o, o + d, n) for n, o, d in inside
                  if family(n) not in ("copy", "async-slice")))
    gaps = []
    cur = w0
    last_name = "(start)"
    for o, e, n in evs:
        if o > cur:
            gaps.append((o - cur, cur, last_name, n))
        if e > cur:
            cur = e
            last_name = n
    if w1 > cur:
        gaps.append((w1 - cur, cur, last_name, "(end)"))
    gaps.sort(reverse=True)
    print(f"\ntop idle gaps (us, after -> before):")
    for d, _o, a, b in gaps[: args.gaps]:
        print(f"  {d/1e6:8.2f}  after {a.split(' = ')[0][:60]:<62} "
              f"before {b.split(' = ')[0][:60]}")
    # gap histogram per step
    n_gaps = len(gaps)
    tot_gap = sum(g[0] for g in gaps) / 1e6
    print(f"\n{n_gaps} gaps totalling {tot_gap:.1f} us "
          f"({tot_gap/args.steps:.2f}/step, {n_gaps/args.steps:.1f} gaps/step)")


if __name__ == "__main__":
    main()
