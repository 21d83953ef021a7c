"""Multi-host execution helpers.

A multi-host scan is the same program as a single-host one: every host
builds runs for its own shard of regions, scans them over its LOCAL
devices (``runscan.scan_batches`` auto-shards over ``jax.local_devices()``)
and the per-motif integer score histograms — the only cross-host data that
must be global — are summed over processes (:func:`allreduce_hist`).
Exact global BH q-values then fall out of the merged histogram on every
host identically; the per-host hit rows are gathered to every host
(:func:`allgather_bytes`) and host 0 writes the report
(:func:`is_report_host`).

Region sharding is deterministic (round-robin over the sorted region list)
so no coordination beyond ``jax.distributed.initialize`` is needed.

Reference analogue: the single-host ``mp.Pool`` data parallelism over TSV
chunks with Manager-dict merges (``score_sequences.py:115-157``); here the
"chunks" are BED regions, the merge is a collective, and the result is
bit-identical to a single-process run (``tests/test_distributed.py``).
"""

import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialise ``jax.distributed`` (no-op on a single host).

    In managed cluster environments (e.g. SLURM) argument-less
    initialisation discovers the topology; otherwise pass coordinator/process info
    explicitly.  Must run before any jax backend initialises.
    """
    import jax

    if num_processes is None and coordinator_address is None:
        try:
            jax.distributed.initialize()
        except Exception:
            return  # single-process
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def shard_regions(
    regions: Sequence[Tuple[str, int, int]],
    process_id: int,
    num_processes: int,
) -> List[Tuple[str, int, int]]:
    """Deterministic round-robin region shard for this host."""
    ordered = sorted(regions)
    return [r for i, r in enumerate(ordered) if i % num_processes == process_id]


def is_report_host() -> bool:
    import jax

    return jax.process_index() == 0


def _global_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("proc",))


def allreduce_hist(hist: np.ndarray) -> np.ndarray:
    """Sum an int64 histogram over all processes (exact).

    The counts ride as float64 (integer-exact below 2**53 — genome-scale
    totals are ~2**35) because the collective path truncates int64
    without ``jax_enable_x64``; the sum converts back to int64.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return hist
    mesh = _global_mesh()
    n_local = len(jax.local_devices())
    # the first local device carries the payload, the rest contribute
    # zeros; one psum over the proc axis merges all hosts
    local = np.zeros((n_local,) + hist.shape, dtype=np.float64)
    local[0] = hist.astype(np.float64)
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("proc")), local
    )
    step = jax.jit(
        jax.shard_map(
            lambda x: jax.lax.psum(x, "proc"),
            mesh=mesh,
            in_specs=P("proc"),
            out_specs=P(),
        )
    )
    out = np.asarray(step(arr))[0]
    return np.rint(out).astype(np.int64)


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Gather one byte string from every process to every process
    (two-step: lengths, then padded payloads)."""
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return [payload]
    n = np.array([len(payload)], dtype=np.int32)
    sizes = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    max_len = int(sizes.max())
    buf = np.zeros(max_len, dtype=np.uint8)
    if payload:
        buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(buf))
    return [
        gathered[i, : int(sizes[i])].tobytes()
        for i in range(jax.process_count())
    ]


def allgather_object(obj) -> List:
    """Gather one picklable object from every process (ordered by
    process index)."""
    return [pickle.loads(b) for b in allgather_bytes(pickle.dumps(obj))]
