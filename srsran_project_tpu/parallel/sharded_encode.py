"""Sharded PDSCH encode — the DOWNLINK direction of the multi-chip layer.

The reference parallelizes DL encode as codeblock batches dispatched over
an executor (pdsch_processor_flexible_impl.cpp:42 — the 371-line batch
pipeline splits the bit chain per codeblock and the RE map per symbol
range).  The equivalent here maps both axes onto the device mesh
with GSPMD sharding annotations and lets XLA insert the collectives
(the scaling-book recipe — pick a mesh, annotate, let the partitioner
place all-gathers):

  - the bit chain (CRC + segment + LDPC encode) shards over the
    CODEBLOCK axis (``cb_axis``): every device LDPC-encodes C/n
    codeblocks — the FLOP-heavy part of DL;
  - rate-match bit selection + scrambling + modulation + DM-RS +
    precoding produce the port grid under a SUBCARRIER sharding
    constraint (``sc_axis``), so the assembled slot grid comes out
    sharded the same way the UL front end (sharded_carrier.py) consumes
    it — DL encode -> channel -> UL decode composes on the mesh without
    a resharding hop in between.

Collectives: one all-gather joining the codeblock-sharded encoder output
into the (replicated) codeword bit stream, plus whatever grid-assembly
movement GSPMD picks for the scatter into the sc-sharded grid.  Asserted
in the dry run via HLO inspection (__graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import scrambling
from ..ops.ldpc import encoder as ldpc_encoder
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc import segmenter
from ..phy import pdsch as pdsch_mod
from ..phy.sch import SchConfig, _e_groups


def _encode_tb_cb_sharded(tb_bits, cfg: SchConfig, mesh: Mesh, cb_axis):
    """TB (A,) -> codeword bits (G,); the segment/LDPC-encode stage is
    constrained to a codeblock sharding so each device encodes C/n CBs."""
    seg = cfg.seg
    cbs = segmenter.segment_tx(tb_bits, seg)  # (C, K)
    cbs = jax.lax.with_sharding_constraint(
        cbs, NamedSharding(mesh, P(cb_axis, None)))
    buf = ldpc_encoder.encode_to_buffer(cbs, seg.base_graph, seg.lifting_size,
                                        n_cb=cfg.n_cb)
    buf = jax.lax.with_sharding_constraint(
        buf, NamedSharding(mesh, P(cb_axis, None)))
    k_prime = seg.nof_payload_bits_per_cb
    pieces = []
    for start, count, e in _e_groups(cfg.cb_e_bits):
        grp = rm.rate_match(
            buf[..., start : start + count, :], seg.base_graph,
            seg.lifting_size, k_prime, e, cfg.rv, cfg.qm, cfg.n_cb)
        pieces.append(grp.reshape(grp.shape[:-2] + (count * e,)))
    return jnp.concatenate(pieces, axis=-1)


@functools.lru_cache(maxsize=None)
def _encode_fn(cfg: pdsch_mod.PdschConfig, mesh: Mesh, cb_axis: str,
               sc_axis: str):
    def fn(tb_bits, rnti, precoding):
        cw = _encode_tb_cb_sharded(tb_bits, cfg.sch, mesh, cb_axis)
        scr = scrambling.scramble_bits(
            cw, pdsch_mod._pdsch_c_init(rnti, cfg.n_id))
        grid = pdsch_mod._grid_chain(scr, precoding, cfg)
        return jax.lax.with_sharding_constraint(
            grid, NamedSharding(mesh, P(None, None, sc_axis)))

    return jax.jit(fn)


def sharded_encode_slot(tb_bits, rnti, precoding, cfg: pdsch_mod.PdschConfig,
                        mesh: Mesh, cb_axis: str = "sp", sc_axis: str = "sp"):
    """One PDSCH slot encode on the mesh.

    tb_bits (A,) uint8, rnti uint32, precoding (nl, nports) complex64 ->
    port grid (nports, nsym, nsc) sharded P(None, None, sc_axis).
    """
    return _encode_fn(cfg, mesh, cb_axis, sc_axis)(
        tb_bits, jnp.asarray(rnti, jnp.uint32),
        jnp.asarray(precoding, jnp.complex64))


def sharded_transmit(tb_bits, rnti, cfg, mesh: Mesh, precoding=None,
                     cb_axis: str = "sp", sc_axis: str = "sp"):
    """UE-grid twin of phy.pusch.transmit, encoded on the mesh: builds the
    same PdschConfig twin and returns the (nports, nsym, nsc) grid sharded
    over ``sc_axis`` — ready for sharded_carrier.sharded_decode."""
    if precoding is None:
        precoding = jnp.eye(cfg.nof_layers, cfg.nof_rx_ports,
                            dtype=jnp.complex64)
    tx_cfg = pdsch_mod.PdschConfig(
        tbs=cfg.tbs, target_code_rate=cfg.target_code_rate,
        modulation=cfg.modulation, alloc=cfg.alloc,
        nof_layers=cfg.nof_layers, nof_ports=int(precoding.shape[-1]),
        nof_grid_symbols=cfg.nof_grid_symbols, nof_grid_sc=cfg.nof_grid_sc,
        slot_in_frame=cfg.slot_in_frame,
        dmrs_scrambling_id=cfg.dmrs_scrambling_id, n_scid=cfg.n_scid,
    )
    return sharded_encode_slot(tb_bits, rnti, precoding, tx_cfg, mesh,
                               cb_axis=cb_axis, sc_axis=sc_axis)


def encode_hlo_text(cfg: pdsch_mod.PdschConfig, mesh: Mesh,
                    cb_axis: str = "sp", sc_axis: str = "sp") -> str:
    """Compiled-HLO text of the sharded encode (for collective asserts)."""
    fn = _encode_fn(cfg, mesh, cb_axis, sc_axis)
    tb = jax.ShapeDtypeStruct((cfg.tbs,), jnp.uint8)
    rnti = jax.ShapeDtypeStruct((), jnp.uint32)
    w = jax.ShapeDtypeStruct((cfg.nof_layers, cfg.nof_ports), jnp.complex64)
    return fn.lower(tb, rnti, w).compile().as_text()
