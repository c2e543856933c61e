"""PDSCH processor: transport block -> resource grid.

Counterpart of the reference's pdsch_processor_flexible_impl
(lib/phy/upper/channel_processors/pdsch/pdsch_processor_flexible_impl.cpp):
segment -> LDPC encode -> rate match -> scramble -> modulate -> layer map ->
precode -> grid, plus the DM-RS generator
(lib/phy/upper/signal_processors/pdsch/dmrs_pdsch_processor_impl.cpp).
Here the whole slot-PDU is one jitted tensor program per static
`PdschConfig`; only bits, RNTI, and the precoding matrix are traced.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import scrambling
from ..ops.modulation import Modulation, map_bits
from ..ran import dmrs as dmrs_mod
from ..support.staging import checkpoint
from . import allocation as alloc_mod
from .sch import SchConfig, encode_transport_block


@dataclasses.dataclass(frozen=True)
class PdschConfig:
    tbs: int
    target_code_rate: float
    modulation: Modulation
    alloc: alloc_mod.Allocation
    nof_layers: int = 1
    nof_ports: int = 1
    nof_grid_symbols: int = 14
    nof_grid_sc: int = 624  # 52 PRB default
    n_id: int = 0  # scrambling identity (cell id or dataScramblingIdentity)
    rv: int = 0
    slot_in_frame: int = 0
    dmrs_scrambling_id: int = 0
    n_scid: int = 0
    # PT-RS: one RE every ptrs_k PRBs on every non-DM-RS allocated symbol
    # (punctures data; the receiver erases those LLRs and uses the pilots
    # for common-phase-error tracking).
    ptrs_enabled: bool = False
    ptrs_k: int = 2  # K_PTRS
    ptrs_re_offset: int = 0  # resourceElementOffset (0..3), Table 7.4.1.2.2-1
    # k_RB_ref = rnti mod K_PTRS (TS 38.211 7.4.1.2.2; rnti is a runtime
    # value in this API, so callers fold it into the config).
    ptrs_k_rb_ref: int = 0
    # Transform precoding (DFT-s-OFDM uplink; used by the PUSCH TX twin):
    # data is DFT-precoded per symbol and the DM-RS is a low-PAPR sequence
    # seeded by n_rs_id (TS 38.211 6.3.1.4 / 6.4.1.1.1.2).
    transform_precoding: bool = False
    n_rs_id: int = 0

    @functools.cached_property
    def sch(self) -> SchConfig:
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        ndata = alloc_mod.nof_data_re(self.alloc)
        g = ndata * qm * self.nof_layers
        return SchConfig(
            tbs=self.tbs,
            target_code_rate=self.target_code_rate,
            qm=qm,
            nof_layers=self.nof_layers,
            nof_total_bits=g,
            rv=self.rv,
        )


def _pdsch_c_init(rnti, n_id: int, q: int = 0):
    return (rnti.astype(jnp.uint32) << 15) + jnp.uint32(q << 14) + jnp.uint32(n_id)


def dmrs_pilots(cfg: PdschConfig, nof_pilots: int) -> jax.Array:
    """(nsym_dmrs, nof_pilots) complex64 DM-RS QPSK values r(m) per symbol."""
    outs = []
    for sym in cfg.alloc.dmrs_symbols:
        c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym, cfg.dmrs_scrambling_id, cfg.n_scid)
        c = scrambling.gold_sequence(np.uint32(c_init), 2 * nof_pilots)
        re = 1.0 - 2.0 * c[0::2].astype(jnp.float32)
        im = 1.0 - 2.0 * c[1::2].astype(jnp.float32)
        outs.append((re + 1j * im) / np.sqrt(2))
    return jnp.stack(outs).astype(jnp.complex64)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _grid_rows_fast(layered, precoding, cfg: PdschConfig, dmrs_override):
    """Static row-wise grid assembly for uniform full-row allocations.

    layered: (nl, ndata) data symbols in symbol-major order.  Data rows
    reshape straight into the grid; type-1 DM-RS rows interleave pilot
    values with zeros at the CDM-group offset (stride 2) — no scatters.
    Output identical to the scatter path (asserted by the parity test)."""
    a = cfg.alloc
    nl = cfg.nof_layers
    nof_sc = a.nof_sc
    data_syms = [s for s in range(a.sym_start, a.sym_start + a.sym_count)
                 if s not in a.dmrs_symbols]
    data3 = layered.reshape(nl, len(data_syms), nof_sc)

    beta = dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data)
    vals_l, delta_l = [], []
    for layer in range(nl):
        _idx, wf, _, seq_idx = alloc_mod.pilot_re_indices(a, layer, cfg.nof_grid_sc)
        if dmrs_override is not None:
            r = dmrs_override[layer]
        else:
            nof_pilots_total = int(seq_idx[-1]) + 1
            r = dmrs_pilots(cfg, nof_pilots_total)[:, jnp.asarray(seq_idx)]
        vals_l.append(np.float32(beta) * r * jnp.asarray(wf, dtype=jnp.complex64))
        delta_l.append(int(dmrs_mod.cdm_group(1, layer)))  # type-1 delta == group

    dmrs_in = [s for s in a.dmrs_symbols
               if a.sym_start <= s < a.sym_start + a.sym_count]
    rows = []  # list of (nl, nof_sc) per slot symbol inside the alloc window
    zero_row = jnp.zeros((nl, nof_sc), jnp.complex64)
    for s in range(cfg.nof_grid_symbols):
        if s in data_syms:
            rows.append(data3[:, data_syms.index(s)])
        elif s in dmrs_in:
            si = list(a.dmrs_symbols).index(s)
            layer_rows = []
            for layer in range(nl):
                v = vals_l[layer][si]  # (nof_sc//2,)
                z = jnp.zeros_like(v)
                pair = (jnp.stack([v, z], axis=-1) if delta_l[layer] == 0
                        else jnp.stack([z, v], axis=-1))
                layer_rows.append(pair.reshape(-1))
            rows.append(jnp.stack(layer_rows))
        else:
            rows.append(zero_row)
    win = jnp.stack(rows, axis=1)  # (nl, S, nof_sc)
    if a.sc_start or nof_sc != cfg.nof_grid_sc:
        left = jnp.zeros((nl, cfg.nof_grid_symbols, a.sc_start), jnp.complex64)
        right = jnp.zeros(
            (nl, cfg.nof_grid_symbols,
             cfg.nof_grid_sc - a.sc_start - nof_sc), jnp.complex64)
        win = jnp.concatenate([left, win, right], axis=-1)
    w = precoding.astype(jnp.complex64)
    return jnp.stack(
        [sum(w[l, p] * win[l] for l in range(nl))
         for p in range(w.shape[1])], axis=0)


def _bit_chain(tb_bits: jax.Array, rnti: jax.Array, cfg: PdschConfig) -> jax.Array:
    """Segment + LDPC encode + rate match + scramble: (A,) -> (G,) bits.

    One compiled program: fusing removes ~10 per-call program dispatches
    (models/cell.py's encode_slot_fused also fuses grid map + OFDM).
    """
    cw = encode_transport_block(tb_bits, cfg.sch)
    return scrambling.scramble_bits(cw, _pdsch_c_init(rnti, cfg.n_id))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _grid_chain(cw: jax.Array, precoding: jax.Array, cfg: PdschConfig,
                dmrs_override=None) -> jax.Array:
    """Modulate + layer map + DM-RS + precode: (G,) bits -> port grids.

    One jitted program: measured to compile in ~11 s at 273 PRB (unlike the
    full-slot fusion, which blows up)."""
    a = cfg.alloc
    syms = map_bits(cw, cfg.modulation)  # (G/Qm,)
    nl = cfg.nof_layers
    layered = syms.reshape(-1, nl).T  # (nl, ndata): symbol i -> layer i%nl

    from .pusch import _uniform_data_rows

    if (_uniform_data_rows(a) and not cfg.transform_precoding
            and not cfg.ptrs_enabled and a.dmrs_config_type == 1):
        # Scatter-free assembly (the flagship shape): every data symbol is
        # a FULL contiguous row of the allocation and type-1 DM-RS sits at
        # stride 2, so the grid builds from static reshapes/stacks instead
        # of a 468k-index scatter (+0.33 ms/slot in the x32 encode chain).
        return _grid_rows_fast(layered, precoding, cfg, dmrs_override)

    grid_l = jnp.zeros((nl, cfg.nof_grid_symbols * cfg.nof_grid_sc), dtype=jnp.complex64)
    didx = jnp.asarray(alloc_mod.data_re_indices(a, cfg.nof_grid_symbols, cfg.nof_grid_sc))
    if cfg.transform_precoding:
        # DFT-s-OFDM: precode each data symbol's M_sc block (1 layer; data
        # symbols carry full PRBs with cdm2, so blocks are contiguous).
        m_sc = a.nof_sc
        blocks = layered.reshape(nl, -1, m_sc)
        blocks = jnp.fft.fft(blocks, axis=-1) / np.sqrt(m_sc)
        layered = blocks.reshape(nl, -1).astype(jnp.complex64)
    grid_l = grid_l.at[:, didx].set(layered)

    # DM-RS: each layer maps to DM-RS port = layer index (v1 convention).
    # Pilots carry the SCH-to-DMRS power offset (+3 dB at 2 CDM groups,
    # TS 38.214; reference sch_dmrs_power.h) relative to data REs.
    beta = dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data)
    for layer in range(nl):
        idx, wf, _, seq_idx = alloc_mod.pilot_re_indices(a, layer, cfg.nof_grid_sc)
        if cfg.transform_precoding:
            # Low-PAPR DM-RS, identical on every DM-RS symbol, indexed from
            # the allocation start (reference
            # dmrs_pusch_estimator_impl.cpp:86-91).
            from ..ops import sequences as seq_mod
            rl = np.asarray(seq_mod.base_sequence(cfg.n_rs_id % 30, 0, len(seq_idx)),
                            np.complex64)
            r = jnp.asarray(np.broadcast_to(rl, (len(a.dmrs_symbols), len(seq_idx))))
        elif dmrs_override is not None:
            # Batched multi-UE path: per-grant pilot values precomputed
            # host-side (the Gold index follows the grant's absolute CRB).
            r = dmrs_override[layer]
        else:
            nof_pilots_total = int(seq_idx[-1]) + 1
            r = dmrs_pilots(cfg, nof_pilots_total)[:, jnp.asarray(seq_idx)]
        vals = np.float32(beta) * r * jnp.asarray(wf, dtype=jnp.complex64)
        grid_l = grid_l.at[layer, jnp.asarray(idx)].set(vals)

    if cfg.ptrs_enabled:
        # Overwrite PT-RS REs on layer 0 (v1: single PT-RS port) with the
        # DM-RS-derived pilot sequence on every data symbol.
        idx_p, vals_p, _ = ptrs_layout(cfg)
        grid_l = grid_l.at[0, jnp.asarray(idx_p)].set(jnp.asarray(vals_p))

    grid_l = grid_l.reshape(nl, cfg.nof_grid_symbols, cfg.nof_grid_sc)
    w = precoding.astype(jnp.complex64)
    # Exact f32 precoding as scalar-weight elementwise multiply-adds: a
    # default-precision einsum may run in bf16/TF32 (an EVM floor on every
    # transmitted RE); the unrolled form is exact and memory-bound (the
    # weight per (l, p) is a scalar).
    nof_ports = w.shape[1]
    return jnp.stack(
        [sum(w[l, p] * grid_l[l] for l in range(nl))
         for p in range(nof_ports)], axis=0)


# TS 38.211 Table 7.4.1.2.2-1 (DM-RS type 1): subcarrier k_RE_ref per
# (resourceElementOffset, PT-RS port); reference ptrs_pattern.cpp:36-38.
_PTRS_K_RE_TYPE1 = ((0, 2, 1, 3), (2, 4, 3, 5), (6, 8, 7, 9), (8, 10, 9, 11))


@functools.lru_cache(maxsize=None)
def ptrs_layout(cfg: PdschConfig):
    """(flat grid indices, pilot values, symbol index per RE) for the PT-RS
    REs of this PDU.

    Reference semantics (ptrs_pdsch_generator_impl.cpp:44-100,
    ptrs_pattern.cpp): ONE DM-RS sequence — c_init from the FIRST DM-RS
    symbol — feeds every PT-RS symbol; PRBs start at rb_start + k_RB_ref
    with stride K_PTRS; the subcarrier comes from the Table 7.4.1.2.2-1
    k_RE_ref for port 0."""
    a = cfg.alloc
    k_re = _PTRS_K_RE_TYPE1[cfg.ptrs_re_offset][0]
    prbs = list(range(a.rb_start + cfg.ptrs_k_rb_ref,
                      a.rb_start + a.rb_count, cfg.ptrs_k))
    data_syms = [s for s in range(a.sym_start, a.sym_start + a.sym_count)
                 if s not in a.dmrs_symbols]
    l0 = min(a.dmrs_symbols)
    c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, l0, cfg.dmrs_scrambling_id, cfg.n_scid)
    nseq = (a.crb_start + a.rb_start + a.rb_count) * 6
    # Host-side LFSR (this helper is lru_cached and also runs inside jit
    # traces, where calling the jitted gold_sequence is not allowed).
    c = scrambling.gold_ref(c_init, 2 * nseq)
    re_p = 1.0 - 2.0 * c[0::2].astype(np.float32)
    im_p = 1.0 - 2.0 * c[1::2].astype(np.float32)
    r = (re_p + 1j * im_p) / np.sqrt(2)
    idx, vals, syms = [], [], []
    for sym in data_syms:
        for prb in prbs:
            idx.append(sym * cfg.nof_grid_sc + prb * 12 + k_re)
            vals.append(r[(a.crb_start + prb) * 6 + k_re // 2])
            syms.append(sym)
    return (np.asarray(idx, np.int32), np.asarray(vals, np.complex64),
            np.asarray(syms, np.int32))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _multi_encode(tbs, rntis, first_scs, dmrs_batch, precoding, grid,
                  cfg: PdschConfig):
    """One compiled program encoding N equal-config PDSCH grants and
    accumulating their windows into the slot grid at per-grant offsets."""

    def one(tb, rnti, r_ov, w_i):
        cw = _bit_chain(tb, rnti, cfg)
        return _grid_chain(cw, w_i, cfg, dmrs_override=r_ov)

    subs = jax.vmap(one)(tbs, rntis, dmrs_batch, precoding)  # (N, P, S, w)
    for i in range(tbs.shape[0]):
        off = first_scs[i]
        win = jax.lax.dynamic_slice(
            grid, (0, 0, off), (grid.shape[0], grid.shape[1], subs.shape[-1]))
        grid = jax.lax.dynamic_update_slice(grid, win + subs[i], (0, 0, off))
    return grid


@functools.lru_cache(maxsize=None)
def _multi_dmrs_bank(cfg: PdschConfig, first_rbs: tuple) -> np.ndarray:
    """(N, nl, nsym_d, Np) per-grant DM-RS pilot values: the only per-UE
    constant of the shared compact encode program (Gold index follows the
    absolute CRB)."""
    banks = []
    for rb0 in first_rbs:
        cfg_i = dataclasses.replace(
            cfg, alloc=dataclasses.replace(cfg.alloc, crb_start=int(rb0)))
        a = cfg_i.alloc
        per_layer = []
        for layer in range(cfg.nof_layers):
            _idx, _wf, _pp, seq_idx = alloc_mod.pilot_re_indices(
                a, layer, cfg.nof_grid_sc)
            ntot = int(seq_idx[-1]) + 1
            rows = []
            for sym in a.dmrs_symbols:
                c_init = dmrs_mod.dmrs_c_init(
                    cfg.slot_in_frame, sym, cfg.dmrs_scrambling_id, cfg.n_scid)
                c = scrambling.gold_ref(int(c_init), 2 * ntot).astype(np.float32)
                r = ((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2)
                rows.append(r[seq_idx])
            per_layer.append(np.stack(rows))
        banks.append(np.stack(per_layer))
    return np.stack(banks).astype(np.complex64)


def process_multi(tbs, rntis, first_rbs, precoding, cfg: PdschConfig,
                  grid=None, nof_slot_sc=None):
    """Encode N equal-config PDSCH grants into one slot grid in ONE
    batched device program (the DL twin of pusch.process_multi; BASELINE
    config #5 multi-UE slot shape).

    tbs: (N, A) payload bits; rntis: (N,); first_rbs: length-N PRB
    offsets; precoding: (nl, P) shared weights or (N, nl, P) per-grant;
    grid: optional existing (P, S, nof_grid_sc_slot) slot grid to
    accumulate into.
    """
    if cfg.ptrs_enabled:
        raise ValueError("process_multi: PT-RS PDUs take the per-PDU path")
    first_rbs = tuple(int(r) for r in first_rbs)
    dmrs_batch = jax.device_put(_multi_dmrs_bank(cfg, first_rbs))
    first_scs = jnp.asarray([12 * r for r in first_rbs], jnp.int32)
    tbs = jnp.asarray(tbs, jnp.uint8)
    if grid is None:
        if nof_slot_sc is None:
            # Carrier width unknown: cover at least the last grant's span
            # AND the config's own grid width so standalone callers get a
            # grid consistent with process()/UpperPhy shapes (ADVICE r3).
            nof_slot_sc = max(cfg.nof_grid_sc,
                              *(12 * (rb + cfg.alloc.rb_count) for rb in first_rbs))
        grid = jnp.zeros((cfg.nof_ports, cfg.nof_grid_symbols, nof_slot_sc),
                         jnp.complex64)
    w = jnp.asarray(precoding, jnp.complex64)
    if w.ndim == 2:
        w = jnp.broadcast_to(w, (tbs.shape[0],) + w.shape)
    return _multi_encode(tbs, jnp.asarray(rntis, jnp.uint32), first_scs,
                         dmrs_batch, w, grid, cfg)


def process(tb_bits: jax.Array, rnti: jax.Array, precoding: jax.Array, cfg: PdschConfig) -> jax.Array:
    """Encode one PDSCH PDU into a resource grid.

    tb_bits:   (A,) payload bits
    rnti:      scalar uint32
    precoding: (nof_layers, nof_ports) complex64
    Returns grid (nof_ports, nof_grid_symbols, nof_grid_sc) complex64.

    Stage-jitted (bit chain vs grid chain) to keep per-program compile time
    bounded on large carriers.
    """
    cw = checkpoint(_bit_chain(tb_bits, jnp.asarray(rnti), cfg))
    return _grid_chain(cw, jnp.asarray(precoding, jnp.complex64), cfg)
