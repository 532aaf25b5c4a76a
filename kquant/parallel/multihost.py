"""Multi-host initialization and meshes.

The reference has no distributed backend at all (SURVEY.md 2.3); here the
transport is not ours to write — ``jax.distributed`` forms the process group
and XLA hands collectives to NCCL: NVLink between the cards of a host, the
network between hosts. The layout rule encoded here: 'model' (TP) and
'expert' (EP) axes stay INSIDE a host's cards, where every card reaches every
other at the same rate; 'data' (DP, the continuous-batching batch axis) spans
hosts, whose links are slower.
"""

from __future__ import annotations

import jax

from kquant.parallel.mesh import make_mesh


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the multi-host process group (no-op when single-process).

    Nothing on a plain GPU host tells JAX of a cluster: pass the coordinator
    address (``host:port``), the process count and this process's id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def pod_mesh(model: int = 1, expert: int = 1):
    """Mesh over ALL devices of the pod slice: DP fills what TP/EP don't.

    ('data' outermost = across hosts over DCN; 'model' innermost = ICI.)
    """
    n = len(jax.devices())
    per = model * expert
    if n % per != 0:
        raise ValueError(f"{n} devices not divisible by model*expert={per}")
    return make_mesh(data=n // per, expert=expert, model=model)


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a [global_batch, ...] input owned by this process (DP)."""
    p = jax.process_index()
    n = jax.process_count()
    per = global_batch // n
    return slice(p * per, (p + 1) * per)
