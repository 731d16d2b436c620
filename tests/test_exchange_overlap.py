"""Exchange/compute overlap evidence for the pipelined case-1 exchange.

BASELINE's north star names "exchange overlapped with build/probe
compute" (SURVEY §7 phase 5). d_case1_probe(chunks=K) splits the left
exchange into K sub-exchanges, each probed as soon as it lands; these
tests prove the program structure in StableHLO (any backend): exactly
K+1 all_to_alls — the exchange is genuinely chunked, and chunk probes
depend only on their own chunk, which is what lets XLA's scheduler
overlap each sub-exchange with the previous chunk's probe (the
successor of the reference's pipelined job queue,
JobScheduler.cpp:103-122 in the reference).
"""

import re

import pytest

pytestmark = pytest.mark.slow


def _lowered(chunks, mesh, axis="x"):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radixhashjoin_tpu.parallel.dist_ops import d_case1_probe

    cap, n = 1024, mesh.shape[axis]
    shard = NamedSharding(mesh, P(axis))

    def arg(sh):
        return jax.ShapeDtypeStruct(sh, jnp.int32, sharding=shard)

    cols, rows, cnts = arg((n * cap,)), arg((n * cap,)), arg((n,))
    return d_case1_probe.lower(mesh, axis, 0.25, chunks, cols, cols,
                               rows, cnts, rows, cnts)


@pytest.mark.parametrize("chunks", [1, 4])
def test_exchange_is_chunked(chunks):
    from radixhashjoin_tpu.parallel.mesh import make_mesh
    low = _lowered(chunks, make_mesh(8))
    stable = low.as_text()
    # K left sub-exchanges + 1 right exchange, nothing fused away
    assert len(re.findall(r"all_to_all", stable)) == chunks + 1
