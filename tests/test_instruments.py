"""Instruments: the xplane trace reader on a trace this test records, and
the kernel-time reduction on a hand-built GPU xplane."""

import jax
import jax.numpy as jnp
import pytest

from kquant.utils.xplane import (device_kernel_ps, device_op_table,
                                 find_xplane, folded_stacks, parse_xspace)


def test_xplane_reader_on_committed_trace(tmp_path):
    """Record a CPU trace of a small jitted computation and parse it: the
    host plane must decode into named lines and timed events."""
    f = jax.jit(lambda x: jnp.tanh(x @ x.T).sum())
    x = jnp.ones((64, 64))
    jax.block_until_ready(f(x))
    jax.profiler.start_trace(str(tmp_path))
    try:
        jax.block_until_ready(f(x))
    finally:
        jax.profiler.stop_trace()
    pb = find_xplane(str(tmp_path))
    planes = parse_xspace(pb)
    names = [p for p, _ in planes]
    assert any("host" in n.lower() for n in names), names
    events = [e for _, lines in planes for _, evs in lines for e in evs]
    assert events and all(dur >= 0 for _, _, dur in events)
    assert any(isinstance(n, str) and n for n, _, _ in events)
    # no GPU plane on the CPU: no device kernel time, an empty op table
    assert device_kernel_ps(pb) == 0
    rows, total = device_op_table(str(tmp_path))
    assert rows == [] and total == 0
    assert folded_stacks(str(tmp_path)) == "\n"


def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num, payload):
    if isinstance(payload, int):
        return _varint(num << 3) + _varint(payload)
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _xspace(planes):
    """planes: [(name, [(line name, [(metadata id, offset_ps, dur_ps)])],
    {metadata id: event name})] -> serialized XSpace bytes."""
    out = b""
    for pname, lines, meta in planes:
        body = _field(2, pname.encode())
        for lname, events in lines:
            line = _field(2, lname.encode())
            for mid, off, dur in events:
                line += _field(4, _field(1, mid) + _field(2, off)
                               + _field(3, dur))
            body += _field(3, line)
        for mid, name in meta.items():
            body += _field(4, _field(1, mid)
                           + _field(2, _field(1, mid) + _field(2, name.encode())))
        out += _field(1, body)
    return out


@pytest.fixture
def gpu_trace(tmp_path):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    pb = d / "host.xplane.pb"
    pb.write_bytes(_xspace([
        ("/device:GPU:0", [
            ("Stream #7(compute)", [(1, 0, 3000), (2, 5000, 2000),
                                    (1, 9000, 1000)]),
            ("XLA Ops", [(1, 0, 3000), (2, 5000, 2000)]),  # derived: skipped
        ], {1: "qmm_q4", 2: "fusion.3"}),
        ("/host:CPU", [("python", [(3, 0, 99999)])], {3: "PjitFunction"}),
    ]))
    return tmp_path, pb


def test_device_kernel_ps_sums_stream_lines(gpu_trace):
    _, pb = gpu_trace
    assert device_kernel_ps(str(pb)) == 6000


def test_device_op_table_on_gpu_planes(gpu_trace):
    tdir, _ = gpu_trace
    rows, total_us = device_op_table(str(tdir))
    assert [(n, c) for n, _, c in rows] == [("qmm_q4", 2), ("fusion.3", 1)]
    assert total_us == pytest.approx(0.006)
    folded = folded_stacks(str(tdir))
    assert "/device:GPU:0;Stream #7(compute);qmm_q4" in folded
    assert "PjitFunction" not in folded


def test_device_kernel_ps_needs_stream_lines(tmp_path):
    pb = tmp_path / "x.xplane.pb"
    pb.write_bytes(_xspace([("/device:GPU:0", [("XLA Ops", [(1, 0, 5)])],
                             {1: "op"})]))
    with pytest.raises(ValueError, match="stream"):
        device_kernel_ps(str(pb))
