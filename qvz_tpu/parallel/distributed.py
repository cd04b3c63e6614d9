"""jax.distributed integration: the DCN-scale communication backend.

`parallel/multihost.py` moves statistics between processes over a
socket control plane; this module runs the SAME integer reductions as
JAX collectives over a GLOBAL device mesh spanning processes — the
deployment shape for multi-node clusters (one process per host,
collectives over the cards' interconnect within a node and the network
across nodes).

Verified live in tests/test_distributed.py: two OS processes, each with
4 virtual CPU devices, form an 8-device global mesh; per-process read
shards reduce with `psum` (gloo CPU collectives) and both processes
derive bit-identical global statistics — and therefore bit-identical
codebooks — matching the single-process result.

Notes for multi-node runs: call initialize() (or let the launcher set
JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID and use
initialize_from_env()) before any JAX computation; the mesh covers
jax.devices() (global), data is placed with
jax.make_array_from_process_local_data, and every reduction payload is
an exact integer sum, so any device/process count produces the same
bytes.
"""

from __future__ import annotations

import os

import numpy as np


def initialize(coordinator: str | None = None, num_processes: int = 1,
               process_id: int = 0) -> None:
    """Bring up jax.distributed (idempotent-ish; call once, first)."""
    import jax

    # NB: nothing that initializes the XLA backend may run before
    # jax.distributed.initialize (no jax.devices/default_backend here).
    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        try:
            # cross-process CPU collectives need gloo
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    else:
        jax.distributed.initialize()  # env/cluster autodetection


def initialize_from_env() -> None:
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        initialize(coord, int(os.environ["JAX_NUM_PROCESSES"]),
                   int(os.environ["JAX_PROCESS_ID"]))
    else:
        initialize()


def global_mesh():
    """Mesh over ALL devices of ALL processes, reads axis."""
    import jax
    from jax.sharding import Mesh

    from qvz_tpu.parallel.mesh import READS_AXIS

    return Mesh(np.array(jax.devices()), (READS_AXIS,))


def distributed_conditional_counts(data_local: np.ndarray,
                                   clusters_local, n_clusters: int):
    """Global conditional histograms from per-process row blocks.

    Every process passes ITS OWN contiguous rows (and cluster ids);
    returns the (replicated) GLOBAL (counts0, cond) — the same exact
    integers on every process, identical to a single-process pass over
    the concatenated rows. Rows per process must be equal across
    processes and divisible by the per-process device count (pad with
    rows of any value and valid=False bits via the `valid_local` arg if
    not naturally aligned)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qvz_tpu.parallel import sharded
    from qvz_tpu.parallel.mesh import READS_AXIS

    mesh = global_mesh()
    n_dev = mesh.devices.size
    nproc = jax.process_count()
    n_local = data_local.shape[0]
    # pad local rows to the per-process device multiple
    per_proc_dev = n_dev // nproc
    pad_to = -(-n_local // per_proc_dev) * per_proc_dev
    valid_local = np.zeros(pad_to, dtype=bool)
    valid_local[:n_local] = True
    dpad = np.zeros((pad_to, data_local.shape[1]), dtype=data_local.dtype)
    dpad[:n_local] = data_local
    cpad = np.zeros(pad_to, dtype=np.int32)
    if clusters_local is not None:
        cpad[:n_local] = clusters_local

    data_sh = NamedSharding(mesh, P(None, READS_AXIS))
    row_sh = NamedSharding(mesh, P(READS_AXIS))
    garr = jax.make_array_from_process_local_data(
        data_sh, np.ascontiguousarray(dpad.T.astype(np.int32)))
    gcl = jax.make_array_from_process_local_data(row_sh, cpad)
    gvalid = jax.make_array_from_process_local_data(row_sh, valid_local)

    fn = sharded.make_sharded_stats(mesh, n_clusters)
    c0, cond = fn(garr, gcl, gvalid)
    c0 = np.asarray(jax.device_get(c0.addressable_data(0)))
    cond = np.asarray(jax.device_get(cond.addressable_data(0)))
    cols = data_local.shape[1]
    from qvz_tpu.constants import ALPHABET_SIZE as A
    return (c0.astype(np.int64),
            cond.reshape(cols - 1, n_clusters, A, A).transpose(1, 0, 2, 3)
            .astype(np.int64))
