"""Codeblock-sharded LDPC decoding across a device mesh.

The north star's "per-codeword LDPC work balanced across chips": a
transport block's codeblocks are embarrassingly parallel, so the (C, N)
LLR batch shards along the dp axis and each device runs the layered
min-sum decoder on its shard; the per-TB CRC verdict needs a single psum
of per-shard failure counts (one all-reduce).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import crc as crc_mod
from ..ops.ldpc import decoder as ldpc_decoder
from ..ops.ldpc import decoder_cuda as ldpc_decoder_cuda
from ..support import platform


def decode_codeblocks_sharded(
    llrs: jax.Array,
    bg: int,
    z: int,
    mesh: Mesh,
    nof_iterations: int = 6,
    axis: str | tuple[str, ...] = "dp",
    n_cb: int | None = None,
):
    """Decode (C, N) codeblock LLRs with C sharded over `axis` (a mesh axis
    name or a tuple of axes, e.g. ("host", "dp") to span hosts over DCN).

    Returns (bits (C, K), nof_crc24b_failures (scalar, psum across shards)).
    C must divide by the axis size (pad with zero-LLR codeblocks upstream).
    Each shard runs the backend's LDPC decoder (support/platform.py); the
    GPU kernel takes int8 LLRs.  n_cb: LBRM buffer length (layer
    truncation, bit-exact for the message).
    """

    def local(shard):
        if platform.ldpc_decoder() == "cuda":
            bits, _ = ldpc_decoder_cuda.decode(shard, bg, z, nof_iterations,
                                               n_cb=n_cb)
        else:
            bits, _ = ldpc_decoder.decode(shard.astype(jnp.float32), bg, z,
                                          nof_iterations, n_cb=n_cb)
        # Per-shard CRC24B failure count, all-reduced over the mesh.
        c = crc_mod.crc(bits, "24B").astype(jnp.int32)
        bad_local = (c.sum(axis=-1) > 0).astype(jnp.int32).sum()
        bad = jax.lax.psum(bad_local, axis)
        return bits, bad

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P()),
    )
    return fn(llrs)


def shard_codeblocks(llrs: np.ndarray, mesh: Mesh, axis: str = "dp"):
    """Pad C to a multiple of the axis size and device_put with sharding."""
    size = (
        int(np.prod([mesh.shape[a] for a in axis]))
        if isinstance(axis, tuple)
        else mesh.shape[axis]
    )
    c = llrs.shape[0]
    pad = (-c) % size
    x = np.pad(llrs, ((0, pad), (0, 0)))
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(axis, None))), c
