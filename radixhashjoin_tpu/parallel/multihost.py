"""Multi-host initialization: one engine process per host, one global mesh.

The reference is strictly single-process shared memory (SURVEY.md §5 —
pthreads, no NCCL/MPI/sockets); this is the multi-host equivalent:
`jax.distributed.initialize` joins every process into one runtime, the
mesh spans all hosts' devices, and the SPMD ops in dist_ops.py run
unchanged — `all_to_all`/`all_gather`/`psum` ride ICI within a host slice
and DCN across hosts. DistExecutor is multi-host clean by construction:
every host readback it performs is of a fully-replicated array (probe
stats, NULL flags, psum'd SUM partials), so all processes take identical
control-flow decisions without extra coordination.

On CPU (tests), cross-process collectives go through Gloo; a 2-process
regression test lives in tests/test_multihost.py.
"""

from __future__ import annotations

from typing import Optional

import jax

from .mesh import make_mesh


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   local_device_ids=None) -> None:
    """Join this process into the global JAX runtime. Call before any
    backend use; afterwards jax.devices() spans every host and
    make_mesh() builds the global mesh."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_mesh(axis: str = "x"):
    """1-D mesh over every device of every initialized process."""
    return make_mesh(axis=axis)


def is_coordinator() -> bool:
    return jax.process_index() == 0


def shutdown() -> None:
    if jax.distributed.is_initialized():
        jax.distributed.shutdown()
