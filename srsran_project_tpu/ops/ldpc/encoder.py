"""LDPC encoder (TS 38.212 §5.3.2), batched.

Counterpart of the reference's ldpc_encoder_generic/avx2/avx512
(lib/phy/upper/channel_coding/ldpc/ldpc_encoder_generic.cpp) — re-designed as
a static jitted program per (bg, z):

* the message is a (batch, K_b*Z) bit vector; every base-graph edge's
  "pick block c, rotate by s" becomes one row of a precomputed flat gather
  index table, so the syndromes of ALL check rows over the message columns
  are computed by a single gather + popcount-mod-2 reduction;
* the double-diagonal high-rate core is solved in closed form (the XOR of
  the four core rows isolates p0 up to a known rotation, then p1..p3 follow
  by back-substitution);
* the extension parity rows are a second gather + reduction over the
  (message + core parity) columns.

No sequential bit arithmetic anywhere; codeblocks batch along the leading
axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .graphs import LdpcGraph, get_graph


def _core_p0_rotation(graph: LdpcGraph) -> int:
    """Rotation r with roll(p0, -r) = XOR of the four core-row syndromes.

    Summing the four core check rows cancels the double-diagonal columns
    (each inner parity column appears twice with shift 0) and leaves
    rot(p0, r) where r is the shift appearing an odd number of times in the
    p0 column (observed (x, y, x) patterns in both base graphs).
    """
    col = graph.kb
    shifts = [s for s in graph.shifts[:4, col] if s >= 0]
    assert len(shifts) == 3, shifts
    a, b, c = sorted(shifts)
    if a == b:
        return c
    if b == c:
        return a
    raise AssertionError(f"unexpected p0 column shifts {shifts}")


@functools.lru_cache(maxsize=None)
def _gather_tables(bg: int, z: int):
    """Precomputed gather tables for the two accumulation phases.

    Returns:
      core_idx  (4, D1, Z) int32 into flat message (+ sink at kb*Z)
      ext_idx   (M-4, D2, Z) int32 into flat [message | core parity]
                (+ sink at (kb+4)*Z)
      core_back [(col_offset, shift)] lists for rows 0..2 back-substitution
      rot       p0 isolation rotation
    """
    g = get_graph(bg, z)
    kb, m = g.kb, g.m
    zidx = np.arange(z)

    def build(rows, max_col, sink):
        edge_lists = []
        for r in rows:
            edge_lists.append([(c, s) for c, s in g.row_edges(r) if c < max_col])
        dmax = max(len(e) for e in edge_lists)
        idx = np.full((len(rows), dmax, z), sink, dtype=np.int32)
        for i, edges in enumerate(edge_lists):
            for e, (col, shift) in enumerate(edges):
                idx[i, e] = col * z + (zidx + shift) % z
        return idx

    core_idx = build(range(4), kb, kb * z)
    ext_idx = build(range(4, m), kb + 4, (kb + 4) * z)
    core_back = []
    for row in range(3):
        core_back.append([(c - kb, s) for c, s in g.row_edges(row) if c >= kb])
    return core_idx, ext_idx, core_back, _core_p0_rotation(g)


@functools.partial(jax.jit, static_argnames=("bg", "z", "n_cb"))
def encode(message: jax.Array, bg: int, z: int,
           n_cb: int | None = None) -> jax.Array:
    """Encode (batch, K_b*Z) message bits -> (batch, N_full = n*Z) codeword.

    Filler bits must already be zeros in `message` (the rate matcher skips
    them by index).  The returned array covers ALL variable nodes including
    the first 2Z punctured ones; slice [..., 2*z:] for the rate-matching
    circular buffer.

    n_cb: LBRM circular-buffer length — extension parity beyond n_cb is
    never transmitted in ANY redundancy version, so those rows are not
    computed (each is a degree-1 output column; the flagship's n_cb=13595
    needs 12 of BG1's 42 extension rows).  The skipped region reads 0.
    """
    g = get_graph(bg, z)
    kb, m = g.kb, g.m
    batch = message.shape[:-1]
    core_idx, ext_idx, core_back, rot = _gather_tables(bg, z)
    if n_cb is not None and n_cb < g.nof_codeword_bits:
        nof_ext = max(0, -(-(n_cb + 2 * z) // z) - kb - 4)
        ext_idx = ext_idx[:nof_ext]
    else:
        nof_ext = m - 4

    msg = message.astype(jnp.uint8)
    msg_flat = jnp.concatenate([msg, jnp.zeros(batch + (1,), jnp.uint8)], axis=-1)

    def accumulate(flat, idx):
        rows, dmax, _ = idx.shape
        gathered = flat[..., idx.reshape(-1)].reshape(batch + (rows, dmax, z))
        return (jnp.sum(gathered, axis=-2, dtype=jnp.int32) & 1).astype(jnp.uint8)

    s_core = accumulate(msg_flat, jnp.asarray(core_idx))  # (batch, 4, Z)

    total = s_core[..., 0, :] ^ s_core[..., 1, :] ^ s_core[..., 2, :] ^ s_core[..., 3, :]
    p0 = jnp.roll(total, rot, axis=-1)
    parity = [p0]
    for row in range(3):
        acc = s_core[..., row, :]
        for col_off, shift in core_back[row]:
            if col_off < len(parity):
                acc = acc ^ jnp.roll(parity[col_off], -shift, axis=-1)
        parity.append(acc)

    head = jnp.concatenate(
        [msg] + [p.reshape(batch + (z,)) for p in parity] + [jnp.zeros(batch + (1,), jnp.uint8)],
        axis=-1,
    )  # (batch, (kb+4)*Z + 1)

    p_ext = accumulate(head, jnp.asarray(ext_idx))  # (batch, nof_ext, Z)

    pieces = [head[..., : (kb + 4) * z],
              p_ext.reshape(batch + (nof_ext * z,))]
    if nof_ext < m - 4:
        pieces.append(jnp.zeros(batch + ((m - 4 - nof_ext) * z,), jnp.uint8))
    out = jnp.concatenate(pieces, axis=-1)
    assert out.shape[-1] == g.n * z
    return out


def encode_to_buffer(message: jax.Array, bg: int, z: int,
                     n_cb: int | None = None) -> jax.Array:
    """Encode and drop the 2Z punctured systematic bits: the rate-matching
    circular buffer d_0..d_{N-1} of TS 38.212 §5.4.2.1."""
    return encode(message, bg, z, n_cb=n_cb)[..., 2 * z :]
