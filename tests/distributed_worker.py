"""Worker process for the 2-process ``jax.distributed`` smoke test.

Each process owns 2 virtual CPU devices; the pair forms a real
multi-process cluster (gloo collectives) whose 4 global devices build the
``pod_mesh``.  The worker asserts a psum across process boundaries — the
collective the grid/TF gradient all-reduce rides in multi-host training
(SURVEY §5 "Distributed communication backend") — then emits one line of
evidence JSON.

Usage: python tests/distributed_worker.py <coordinator> <n_procs> <pid>
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()


def main():
    coordinator, n_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    import jax.numpy as jnp
    import numpy as np

    from volumetric_renderer.parallel.distributed import (
        init_distributed, local_batch_bounds, pod_mesh,
    )

    init_distributed(coordinator, n_procs, pid)
    assert jax.process_count() == n_procs, jax.process_count()
    assert len(jax.devices()) == 2 * n_procs  # global view
    assert len(jax.local_devices()) == 2

    mesh = pod_mesh()
    assert mesh.shape == {"hosts": n_procs, "tiles": 2}

    # psum across the whole mesh — including the process (DCN) axis
    def body(x):
        return jax.lax.psum(x, ("hosts", "tiles"))

    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=P(("hosts", "tiles")),
                      out_specs=P()),
        out_shardings=NamedSharding(mesh, P()),
    )
    # global (4,) array: each device contributes its global index + 1
    from jax.experimental import multihost_utils

    local = np.asarray([2 * pid + 1, 2 * pid + 2], np.float32)
    glob = multihost_utils.host_local_array_to_global_array(
        local, mesh, P(("hosts", "tiles")))
    total = sharded(glob)
    got = float(np.asarray(jax.device_get(
        total.addressable_data(0))).reshape(-1)[0])
    want = float(sum(range(1, 2 * n_procs + 1)))
    assert got == want, (got, want)

    lo, hi = local_batch_bounds(64)
    print(json.dumps({"pid": pid, "psum": got, "rows": [lo, hi]}),
          flush=True)


if __name__ == "__main__":
    main()
