"""Device timing from `jax.profiler` traces.

JAX returns before the device finishes, and a µs-scale kernel is shorter than
one dispatch, so host clocks cannot time a kernel. ``device_seconds`` traces a
few calls and sums the durations of the kernels the device ran
(``utils.xplane.device_kernel_ps``).
"""

from __future__ import annotations

import tempfile

import jax

from kquant.utils.xplane import device_kernel_ps, find_xplane


def device_seconds(fn, *args, reps: int = 20) -> float:
    """Mean device time of one ``fn(*args)``: kernel time summed over the
    device planes of a trace of ``reps`` calls, after one warm-up call."""
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        try:
            out = None
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        finally:
            jax.profiler.stop_trace()
        ps = device_kernel_ps(find_xplane(d))
    if ps <= 0:
        raise RuntimeError("the trace holds no device kernel events")
    return ps / reps / 1e12
