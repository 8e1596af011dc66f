"""Multi-host initialization and pod-slice topology helpers.

The reference is one process / one device / one thread (SURVEY.md §2.4);
scaling past one host here follows the JAX SPMD model: every host runs
the same program, ``jax.distributed.initialize`` wires the cluster, and
the mesh spans all global devices — collectives (NCCL on GPUs) ride
NVLink within a host and the network across hosts.  Failure model (SURVEY.md §5): fail-fast; a
crashed host aborts the job, which restarts from the latest checkpoint
(``utils.checkpoint``) — JAX has no elastic recovery.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from volumetric_renderer.parallel.mesh import HOST_AXIS, TILE_AXIS

log = logging.getLogger("volumetric_renderer")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (no-op on a single process).

    Without arguments JAX looks for a cluster environment it knows (for
    example a Slurm allocation) and this is a no-op when there is none;
    elsewhere pass all three.  Must be called before any other JAX API
    touches devices.
    """
    if num_processes is None and coordinator_address is None:
        try:
            jax.distributed.initialize()
        except (ValueError, RuntimeError) as e:
            # single-process run (no cluster env): proceed standalone
            log.info('{"distributed": "single-process", "reason": "%s"}',
                     str(e).splitlines()[0])
            return
    else:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
    log.info('{"distributed": "initialized", "process": %d, "hosts": %d}',
             jax.process_index(), jax.process_count())


def pod_mesh() -> Mesh:
    """2D ``(hosts, tiles)`` mesh over all global devices.

    Image rows shard over *both* axes (``PartitionSpec(("hosts",
    "tiles"))``), so the forward pass stays communication-free; gradient
    psums reduce hierarchically — over NVLink within each host's cards,
    then once over the network across hosts.
    """
    n_hosts = jax.process_count()
    devs = np.asarray(jax.devices())
    per_host = devs.size // n_hosts
    return Mesh(devs.reshape(n_hosts, per_host), (HOST_AXIS, TILE_AXIS))


def local_batch_bounds(total_rows: int) -> Tuple[int, int]:
    """Row range this host materializes when feeding per-host data."""
    n = jax.process_count()
    i = jax.process_index()
    per = -(-total_rows // n)
    return i * per, min(total_rows, (i + 1) * per)
