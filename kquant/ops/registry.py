"""The one seam between an op and its hand-written kernels.

``KERNELS`` maps each op to the kernel it has on each JAX backend. An op runs
its plain XLA version wherever it has no kernel. ``impl`` says what the caller
asks for:

  'xla'     the plain version, on any backend;
  'auto'    the backend's kernel where the op's own gate takes it, else XLA;
  'pallas'  the backend's kernel, and an error where there is none.

``interpret=True`` runs an op's kernel in the Pallas interpreter on whatever
backend is active. Only tests ask for it: nothing falls back to it.
"""

from __future__ import annotations

import jax

IMPLS = ("auto", "xla", "pallas")

KERNELS: dict[str, dict[str, str]] = {
    "qmm": {"gpu": "triton"},  # ops.qmm_triton
}


def kernel_for(op: str, impl: str = "auto", *,
               interpret: bool = False) -> str | None:
    """The kernel ``op`` runs under ``impl``, or None for the XLA version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "xla":
        return None
    kernels = KERNELS.get(op, {})
    if interpret:
        if not kernels:
            raise NotImplementedError(f"{op!r} has no kernel to interpret")
        return next(iter(kernels.values()))
    backend = jax.default_backend()
    kernel = kernels.get(backend)
    if kernel is None and impl == "pallas":
        raise NotImplementedError(
            f"{op!r} has no kernel on the {backend!r} backend")
    return kernel
