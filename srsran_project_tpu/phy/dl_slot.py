"""Downlink slot broadcast bundling: PDCCH + SSB + CSI-RS in ONE program.

The reference's DL slot walks its PDU list dispatching each processor
into the executor fabric (downlink_processor_impl); the per-PDU device
analogue costs one device program per PDCCH/SSB/CSI-RS PDU plus a grid
accumulation each.  This module traces every broadcast PDU of the slot
into a single compiled program keyed by the (static) tuple of configs —
the DL twin of the heterogeneous UL slot program (phy/ul_slot.py): a
control-heavy slot (PDCCH fan-out + SSB + CSI-RS) runs in one dispatch
regardless of PDU count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import csi_rs as csi_rs_mod
from . import pdcch as pdcch_mod
from . import ssb as ssb_mod


@functools.partial(jax.jit, static_argnames=("pdcch_cfgs", "ssb_meta",
                                             "csi_cfgs"))
def _broadcast_program(grid, pdcch_payloads, pdcch_rntis, ssb_payloads,
                       pdcch_cfgs, ssb_meta, csi_cfgs):
    """One compiled program accumulating every broadcast PDU onto port 0.

    pdcch_payloads/ssb_payloads: tuples of bit arrays (ragged lengths are
    fine — pytree leaves); pdcch_rntis: (N,) uint32; pdcch_cfgs/csi_cfgs:
    static config tuples; ssb_meta: tuple of (first_symbol,
    first_subcarrier, SsbConfig)."""
    for i, (pay, c) in enumerate(zip(pdcch_payloads, pdcch_cfgs)):
        grid = grid.at[0].add(pdcch_mod.process(pay, pdcch_rntis[i], c))
    for pay, (first_symbol, first_sc, scfg) in zip(ssb_payloads, ssb_meta):
        g = ssb_mod.assemble_ssb(pay, scfg)
        grid = grid.at[
            0,
            first_symbol : first_symbol + ssb_mod.SSB_NSYM,
            first_sc : first_sc + ssb_mod.SSB_NSC,
        ].add(g)
    for c in csi_cfgs:
        grid = grid.at[0].add(csi_rs_mod.generate(c))
    return grid


def assemble_broadcast(grid, request, phy_cfg):
    """Accumulate request.pdcch / request.ssb / request.csi_rs onto the
    slot grid in one device program (no-op without broadcast PDUs)."""
    if not (request.pdcch or request.ssb or request.csi_rs):
        return grid
    pdcch_cfgs = tuple(p.config for p in request.pdcch)
    pdcch_payloads = tuple(jnp.asarray(p.payload, jnp.uint8)
                           for p in request.pdcch)
    pdcch_rntis = jnp.asarray([p.rnti for p in request.pdcch] or [0],
                              jnp.uint32)
    ssb_meta = tuple((p.first_symbol, p.first_subcarrier, p.config)
                     for p in request.ssb)
    ssb_payloads = tuple(jnp.asarray(p.payload, jnp.uint8)
                         for p in request.ssb)
    csi_cfgs = tuple(
        csi_rs_mod.CsiRsConfig(
            rb_start=p.rb_start, rb_count=p.rb_count, symbol=p.symbol,
            scrambling_id=p.scrambling_id,
            slot_in_frame=request.slot.slot_in_frame,
            nof_grid_symbols=phy_cfg.nof_grid_symbols,
            nof_grid_sc=phy_cfg.nof_grid_sc,
        ) for p in request.csi_rs)
    return _broadcast_program(grid, pdcch_payloads, pdcch_rntis,
                              ssb_payloads, pdcch_cfgs, ssb_meta, csi_cfgs)
