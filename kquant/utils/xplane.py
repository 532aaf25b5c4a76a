"""Minimal pure-python XSpace/XPlane protobuf reader: per-op DEVICE timings
from a `jax.profiler.trace` capture, no tensorflow/tensorboard needed.

The trace instrument (the reference ships flame.svg + out.folded; here the
device timeline lives in the xplane.pb that `jax.profiler` writes: device
planes "/device:GPU:N" with one line per stream and picosecond durations).
This module decodes the protobuf wire format directly against the XPlane
schema (tensorflow/core/profiler/protobuf/xplane.proto, stable since 2020):

  XSpace.planes=1 / XPlane{id=1,name=2,lines=3,event_metadata=4(map),
  stat_metadata=5} / XLine{id=1,name=2,timestamp_ns=3,events=4} /
  XEvent{metadata_id=1,offset_ps=2,duration_ps=3,stats=4} /
  XEventMetadata{id=1,name=2,display_name=4} / XStat{metadata_id=1,...}
"""

from __future__ import annotations

import glob
import gzip
import os
from collections import defaultdict


def _varint(buf: memoryview, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _varint(buf, i)
        elif wt == 1:  # 64-bit
            v = bytes(buf[i:i + 8])
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            v = bytes(buf[i:i + 4])
            i += 4
        else:  # pragma: no cover - groups unused by xplane
            raise ValueError(f"wire type {wt}")
        yield fnum, wt, v


def _parse_event(buf: memoryview) -> tuple[int, int, int]:
    mid = off_ps = dur_ps = 0
    for f, _, v in _fields(buf):
        if f == 1:
            mid = v
        elif f == 2:
            off_ps = v
        elif f == 3:
            dur_ps = v
    return mid, off_ps, dur_ps


def _parse_line(buf: memoryview):
    name = ""
    events = []
    for f, wt, v in _fields(buf):
        if f == 2 and wt == 2:
            name = bytes(v).decode("utf-8", "replace")
        elif f == 4 and wt == 2:
            events.append(_parse_event(v))
    return name, events


def _parse_meta_entry(buf: memoryview):
    """map<int64, XEventMetadata> entry -> (id, name)."""
    key = 0
    name = ""
    for f, wt, v in _fields(buf):
        if f == 1 and wt == 0:
            key = v
        elif f == 2 and wt == 2:
            for f2, wt2, v2 in _fields(v):
                if f2 == 2 and wt2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
    return key, name


def parse_xspace(path: str):
    """Returns [(plane_name, [(line_name, [(event_name, off_ps, dur_ps)])])]."""
    data = open(path, "rb").read()
    planes = []
    for f, wt, v in _fields(memoryview(data)):
        if f != 1 or wt != 2:
            continue
        pname = ""
        lines_raw = []
        meta = {}
        for f2, wt2, v2 in _fields(v):
            if f2 == 2 and wt2 == 2:
                pname = bytes(v2).decode("utf-8", "replace")
            elif f2 == 3 and wt2 == 2:
                lines_raw.append(v2)
            elif f2 == 4 and wt2 == 2:
                k, nm = _parse_meta_entry(v2)
                meta[k] = nm
        lines = []
        for lr in lines_raw:
            lname, events = _parse_line(lr)
            lines.append((lname, [(meta.get(mid, f"#{mid}"), off, dur)
                                  for mid, off, dur in events]))
        planes.append((pname, lines))
    return planes


def device_kernel_ps(path: str) -> int:
    """Total duration of the kernels on the GPU device planes of one xplane
    file. Only the per-stream lines count: derived lines ("XLA Ops", "XLA
    Modules", "Steps") repeat the same time."""
    total = 0
    seen = []
    for pname, lines in parse_xspace(path):
        if not pname.startswith("/device:GPU"):
            continue
        for lname, events in lines:
            seen.append(lname)
            if lname.startswith("Stream"):
                total += sum(dur for _n, _off, dur in events)
    if seen and not total:
        raise ValueError(f"no stream lines on the GPU planes: {seen}")
    return total


def find_xplane(trace_dir: str) -> str:
    hits = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not hits:
        raise FileNotFoundError(f"no xplane.pb under {trace_dir}")
    return hits[-1]


def device_op_table(trace_dir: str, top: int = 0):
    """Aggregate DEVICE-plane events by op name.

    Returns (rows, total_device_us) with rows = [(name, total_us, count)]
    sorted by time desc. Only the stream lines of the GPU device planes
    count (device_kernel_ps); host planes and derived lines are excluded."""
    planes = parse_xspace(find_xplane(trace_dir))
    agg = defaultdict(lambda: [0, 0])
    total = 0
    for pname, lines in planes:
        if not pname.startswith("/device:GPU"):
            continue
        for lname, events in lines:
            if not lname.startswith("Stream"):
                continue
            for name, _off, dur in events:
                agg[name][0] += dur
                agg[name][1] += 1
                total += dur
    rows = sorted(((n, d / 1e6, c) for n, (d, c) in agg.items()),
                  key=lambda r: -r[1])
    if top:
        rows = rows[:top]
    return rows, total / 1e6


def folded_stacks(trace_dir: str) -> str:
    """Emit the device op table in collapsed/folded flamegraph format
    (`plane;line;op count_us`) — the out.folded analog."""
    planes = parse_xspace(find_xplane(trace_dir))
    out = []
    for pname, lines in planes:
        if not pname.startswith("/device:GPU"):
            continue
        for lname, events in lines:
            agg = defaultdict(int)
            for name, _off, dur in events:
                agg[name] += dur
            for name, dur in sorted(agg.items(), key=lambda kv: -kv[1]):
                clean = name.replace(";", ",")
                out.append(f"{pname};{lname};{clean} {dur / 1e6:.1f}")
    return "\n".join(out) + "\n"
