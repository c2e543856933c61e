"""Worker process for the real multi-host (DCN) test.

Run as `python tests/dcn_worker.py <process_id> <num_processes> <port>`.
Each process owns 4 virtual CPU devices; jax.distributed stitches them into
one 8-device global mesh with the host axis on the process boundary, so
"host"-axis collectives actually cross the (loopback) DCN between two OS
processes — the same code path a multi-host deployment uses.

Exercised framework surface:
  - parallel.multihost.initialize (jax.distributed bring-up)
  - host_mesh() real mode (host axis inferred from process boundaries)
  - global_batch (per-host data-plane input assembly)
  - metrics_allreduce (cross-host KPM rollup)
  - sharded_decode.decode_codeblocks_sharded over ("host", "dp")
"""

import os
import sys

pid = int(sys.argv[1])
nprocs = int(sys.argv[2])
port = int(sys.argv[3])

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"  # virtual CPU devices, one mesh per process
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from srsran_project_tpu.parallel import multihost  # noqa: E402

multihost.initialize(f"localhost:{port}", num_processes=nprocs, process_id=pid)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from srsran_project_tpu.ops.ldpc import encoder, graphs  # noqa: E402
from srsran_project_tpu.parallel import sharded_decode  # noqa: E402

assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.devices()) == 4 * nprocs, jax.devices()
assert jax.local_device_count() == 4

mesh = multihost.host_mesh()  # host axis = process boundary
assert mesh.axis_names == ("host", "dp", "tp")
assert mesh.devices.shape == (nprocs, 4, 1), mesh.devices.shape

# --- 1. Cross-host metrics rollup (psum over host+dp rides the DCN) ---
local_metrics = np.full((4, 1), float(pid + 1), np.float32)  # one per local cell
x = multihost.global_batch(mesh, local_metrics)
rollup = multihost.metrics_allreduce(mesh)
total = float(np.asarray(rollup(x))[0, 0])
expect = sum(4.0 * (p + 1) for p in range(nprocs))
assert total == expect, (total, expect)

# --- 2. Codeblock-sharded LDPC decode spanning both hosts ---
bg, z = 2, 52
g = graphs.get_graph(bg, z)
c_global = 4 * nprocs * 2  # 2 codeblocks per device
rng = np.random.default_rng(7)  # same on every process (broadcast msg)
from srsran_project_tpu.ops import crc as crc_mod  # noqa: E402

payload = rng.integers(0, 2, size=(c_global, g.kb * z - 24), dtype=np.uint8)
msg = jnp.asarray(crc_mod.crc_append(payload, "24B"))  # CRC24B per codeblock
cw = np.asarray(encoder.encode(msg, bg, z))
llr_global = np.where(cw[:, 2 * z:] == 0, 12.0, -12.0).astype(np.float32)

rows_per_proc = c_global // nprocs
local_rows = llr_global[pid * rows_per_proc: (pid + 1) * rows_per_proc]
llrs = multihost.global_batch(mesh, local_rows, P(("host", "dp"), None))
bits, bad = sharded_decode.decode_codeblocks_sharded(
    llrs, bg, z, mesh, nof_iterations=4, axis=("host", "dp")
)
# `bad` is replicated (psum over the whole mesh): readable on every process.
assert int(np.asarray(bad)) == 0, int(np.asarray(bad))
# Each process verifies the payload bits of its own shards.
msg_np = np.asarray(msg)
for shard in bits.addressable_shards:
    row0 = shard.index[0].start or 0
    got = np.asarray(shard.data)[:, : g.kb * z]
    np.testing.assert_array_equal(got, msg_np[row0: row0 + got.shape[0]])

print(f"DCN-OK pid={pid} devices={len(jax.devices())} rollup={total}", flush=True)
