"""UL-SCH demultiplexing: HARQ-ACK / CSI multiplexed with data on PUSCH.

Counterpart of the reference's ulsch_demultiplex_impl
(lib/phy/upper/channel_processors/pusch/ulsch_demultiplex_impl.cpp) driven
by lib/ran/pusch/ulsch_info.cpp, implementing the TS 38.212 §6.2.7
multiplexing procedure:

* HARQ-ACK starts at l1 (the first data symbol after the first run of
  DM-RS symbols).  For payloads of 1-2 bits the ACK REs are RESERVED
  (layout sized by ``g_ack_rvd``, the G computed for a 2-bit payload);
  data maps straight through the reserved REs and the actual coded ACK
  bits then PUNCTURE the first G_ack of them.  For payloads > 2 bits the
  data is rate-matched around the ACK REs.
* CSI part 1 starts at l0 (the first data symbol) and is always
  rate-matched around; it never maps onto reserved/ACK REs.
* Within a symbol, a stream needing fewer REs than are available is
  spread evenly with stride d = floor(M / n_re) (the spec's distance
  rule); otherwise it takes the whole symbol and continues.

Positions are computed host-side per static config; mux/demux are pure
gathers/scatters on bit streams of G = nof_data_re * Qm * nof_layers.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import uci as uci_mod
from . import allocation as alloc_mod


@dataclasses.dataclass(frozen=True)
class UlschMuxConfig:
    alloc: alloc_mod.Allocation
    qm: int
    nof_layers: int
    nof_grid_symbols: int
    nof_grid_sc: int
    g_ack: int = 0  # coded HARQ-ACK bits (0 = none)
    g_csi1: int = 0  # coded CSI part-1 bits (0 = none)
    g_csi2: int = 0  # coded CSI part-2 bits (0 = none)
    nof_ack_bits: int = 0  # ACK payload size (selects puncture vs rate-match)
    g_ack_rvd: int = 0  # reserved-ACK layout bits (2-bit G); 0 -> use g_ack

    @property
    def g_total(self) -> int:
        return alloc_mod.nof_data_re(self.alloc) * self.qm * self.nof_layers

    @property
    def ack_punctures(self) -> bool:
        """1-2 bit ACK payloads puncture; larger payloads rate-match."""
        return self.nof_ack_bits <= 2

    @property
    def nof_data_bits(self) -> int:
        """SCH bits carried: G minus CSI minus (rate-matched ACK)."""
        g = self.g_total - self.g_csi1 - self.g_csi2
        if self.g_ack and not self.ack_punctures:
            g -= self.g_ack
        return g


def _select_every_d(avail: np.ndarray, d: int, count: int) -> np.ndarray:
    """Every d-th element of the available set, `count` picks (reference
    ulsch_demultiplex_impl re_set_select)."""
    return avail[::d][:count]


@functools.lru_cache(maxsize=None)
def _layout(cfg: UlschMuxConfig):
    """(ack_pos, csi_pos, csi2_pos, data_idx) bit indices into the G stream.

    Faithful host-side port of the reference's per-OFDM-symbol budgeting
    (ulsch_demultiplex_impl.cpp configure_current_ofdm_symbol, steps 1-5):
    per symbol, reserve ACK REs (<=2-bit payloads) or allocate ACK
    (>2 bits), then CSI1 avoiding reserved, then CSI2, with every-d-th-RE
    spreading and running bit remainders across symbols; <=2-bit ACK REs
    stride within the per-symbol reserved set and puncture whatever maps
    there.  ack_pos carries the actual coded ACK bit positions; data_idx
    enumerates the SCH stream (including reserved/punctured REs in
    puncture mode)."""
    a = cfg.alloc
    bpre = cfg.qm * cfg.nof_layers
    didx = alloc_mod.data_re_indices(a, cfg.nof_grid_symbols, cfg.nof_grid_sc)
    sym_of_re = np.asarray(didx) // cfg.nof_grid_sc
    symbols = list(range(a.sym_start, a.sym_start + a.sym_count))
    re_by_sym = {s: np.nonzero(sym_of_re == s)[0] for s in symbols}
    data_syms = [s for s in symbols if len(re_by_sym[s])]
    dmrs = sorted(a.dmrs_symbols)
    # l1: first symbol after the end of the first DM-RS run; l1_csi: first
    # data symbol (reference get_ulsch_demultiplex_l1/_l1_csi).
    end_first_dmrs = dmrs[0]
    while end_first_dmrs + 1 in dmrs:
        end_first_dmrs += 1
    after = [s for s in data_syms if s > end_first_dmrs]
    l1 = after[0] if after else data_syms[0]
    l1_csi = [s for s in data_syms if s not in dmrs][0]

    punct = cfg.ack_punctures
    g_rvd = (cfg.g_ack_rvd or cfg.g_ack) if punct else 0
    g_ack = cfg.g_ack
    g_csi1 = cfg.g_csi1
    g_csi2 = cfg.g_csi2

    m_rvd = m_ack = m_csi1 = m_csi2 = 0
    ack_res: list = []
    csi1_res: list = []
    csi2_res: list = []
    nondata_res: set = set()

    for s in data_syms:
        res = re_by_sym[s]  # indices into the data-RE enumeration
        is_dmrs_sym = s in dmrs
        uci = res if not is_dmrs_sym else res[:0]
        m_uci = len(uci)
        rvd_set = np.zeros(0, np.int64)

        # Step 1: reserve ACK REs (<=2-bit payloads).
        rem_rvd = (g_rvd - m_rvd) // bpre
        if punct and s >= l1 and m_uci > 0 and rem_rvd > 0:
            d, m_cnt = 1, m_uci
            if rem_rvd < m_uci:
                d, m_cnt = m_uci // rem_rvd, rem_rvd
            rvd_set = _select_every_d(uci, d, m_cnt)
            m_rvd += m_cnt * bpre

        # Step 2: allocate ACK (> 2-bit payloads).
        rem_ack = (g_ack - m_ack) // bpre
        if (not punct) and s >= l1 and m_uci > 0 and rem_ack > 0:
            d, m_cnt = 1, m_uci
            if rem_ack < m_uci:
                d, m_cnt = m_uci // rem_ack, rem_ack
            sel = _select_every_d(uci, d, m_cnt)
            ack_res += list(sel)
            nondata_res |= set(int(x) for x in sel)
            uci = np.asarray([r for r in uci if r not in set(sel)])
            m_uci = len(uci)
            m_ack += m_cnt * bpre

        # Step 3: CSI part 1 (avoids reserved REs).
        rem_csi1 = (g_csi1 - m_csi1) // bpre
        m_avail = m_uci - len(rvd_set)
        if s >= l1_csi and m_avail > 0 and rem_csi1 > 0:
            d, m_cnt = 1, m_avail
            if rem_csi1 < m_avail:
                d, m_cnt = m_avail // rem_csi1, rem_csi1
            cand = np.asarray([r for r in uci if r not in set(rvd_set)])
            sel = _select_every_d(cand, d, m_cnt)
            csi1_res += list(sel)
            nondata_res |= set(int(x) for x in sel)
            uci = np.asarray([r for r in uci if r not in set(sel)])
            m_uci = len(uci)
            m_csi1 += m_cnt * bpre

        # Step 3bis: CSI part 2 (may use reserved REs).
        rem_csi2 = (g_csi2 - m_csi2) // bpre
        if s >= l1_csi and m_uci > 0 and rem_csi2 > 0:
            d, m_cnt = 1, m_uci
            if rem_csi2 < m_uci:
                d, m_cnt = m_uci // rem_csi2, rem_csi2
            sel = _select_every_d(uci, d, m_cnt)
            csi2_res += list(sel)
            nondata_res |= set(int(x) for x in sel)
            uci = np.asarray([r for r in uci if r not in set(sel)])
            m_uci = len(uci)
            m_csi2 += m_cnt * bpre

        # Step 5: <=2-bit ACK strides within this symbol's reserved set.
        rem_ack = (g_ack - m_ack) // bpre
        m_rvd_sym = len(rvd_set)
        if punct and m_rvd_sym > 0 and rem_ack > 0:
            d, m_cnt = 1, m_rvd_sym
            if rem_ack < m_rvd_sym:
                d, m_cnt = m_rvd_sym // rem_ack, rem_ack
            ack_res += list(_select_every_d(rvd_set, d, m_cnt))
            m_ack += m_cnt * bpre

    def bits_of(res: list, limit: int) -> np.ndarray:
        if not res:
            return np.zeros(0, np.int32)
        arr = (np.asarray(sorted(res), np.int64)[:, None] * bpre
               + np.arange(bpre)[None, :]).reshape(-1)
        return arr[:limit].astype(np.int32)

    ack_pos = bits_of(ack_res, cfg.g_ack)
    csi_pos = bits_of(csi1_res, cfg.g_csi1)
    csi2_pos = bits_of(csi2_res, cfg.g_csi2)
    data_mask = np.ones(len(didx), dtype=bool)
    if nondata_res:
        data_mask[np.asarray(sorted(nondata_res))] = False
    data_re = np.nonzero(data_mask)[0]
    data_idx = (data_re[:, None] * bpre + np.arange(bpre)[None, :]) \
        .reshape(-1).astype(np.int32)
    return ack_pos, csi_pos, csi2_pos, data_idx


def _positions(cfg: UlschMuxConfig):
    """(ack_pos, csi_pos) bit indices — kept for tests/back-compat."""
    ack_pos, csi_pos, _, _ = _layout(cfg)
    return ack_pos, csi_pos


def multiplex(data_bits: jax.Array, ack_bits: jax.Array | None, csi1_bits: jax.Array | None,
              cfg: UlschMuxConfig, csi2_bits: jax.Array | None = None) -> jax.Array:
    """Build the transmitted G-bit stream.

    data_bits: (nof_data_bits,) SCH bits; ack/csi1/csi2 are PAYLOAD bits
    (encoded here with the UCI codec).  ACK is placed last so it punctures
    whatever occupies its reserved REs (data or CSI2)."""
    ack_pos, csi_pos, csi2_pos, data_idx = _layout(cfg)
    g = cfg.g_total
    out = jnp.zeros((g,), jnp.uint8)
    out = out.at[jnp.asarray(data_idx)].set(data_bits.astype(jnp.uint8))
    if cfg.g_csi1:
        coded = uci_mod.encode_uci(csi1_bits, cfg.g_csi1)
        out = out.at[jnp.asarray(csi_pos)].set(coded.astype(jnp.uint8))
    if cfg.g_csi2:
        coded = uci_mod.encode_uci(csi2_bits, cfg.g_csi2)
        out = out.at[jnp.asarray(csi2_pos)].set(coded.astype(jnp.uint8))
    if cfg.g_ack:
        coded = uci_mod.encode_uci(ack_bits, cfg.g_ack)
        out = out.at[jnp.asarray(ack_pos)].set(coded.astype(jnp.uint8))
    return out


def demultiplex(llrs: jax.Array, cfg: UlschMuxConfig):
    """Split received G-bit LLRs into (data_llrs, ack_llrs, csi1_llrs).

    In puncture mode the actual ACK bit positions are erased (0) in the
    data stream; rate-matched ACK and CSI positions are removed entirely."""
    ack_pos, csi_pos, csi2_pos, data_idx = _layout(cfg)
    ack_llrs = llrs[..., jnp.asarray(ack_pos)] if cfg.g_ack else None
    csi_llrs = llrs[..., jnp.asarray(csi_pos)] if cfg.g_csi1 else None
    rest = llrs
    if cfg.g_ack and cfg.ack_punctures:
        rest = rest.at[..., jnp.asarray(ack_pos)].set(0)
    data = rest[..., jnp.asarray(data_idx)]
    csi2_llrs = rest[..., jnp.asarray(csi2_pos)] if cfg.g_csi2 else None
    return data, ack_llrs, csi_llrs, csi2_llrs


def decode_uci_parts(ack_llrs, csi_llrs, nof_ack_bits: int, nof_csi1_bits: int,
                     csi2_llrs=None, nof_csi2_bits: int = 0):
    """Decode the UCI payloads; returns dict of (bits, ok) per part."""
    out = {}
    if ack_llrs is not None and nof_ack_bits:
        bits, ok = uci_mod.decode_uci(ack_llrs.astype(jnp.float32), nof_ack_bits)
        out["ack"] = (bits, ok)
    if csi_llrs is not None and nof_csi1_bits:
        bits, ok = uci_mod.decode_uci(csi_llrs.astype(jnp.float32), nof_csi1_bits)
        out["csi1"] = (bits, ok)
    if csi2_llrs is not None and nof_csi2_bits:
        bits, ok = uci_mod.decode_uci(csi2_llrs.astype(jnp.float32), nof_csi2_bits)
        out["csi2"] = (bits, ok)
    return out


def ack_placeholder_descramble(ack_llrs: jax.Array, scr_bits: jax.Array, qm: int,
                               nof_ack_bits: int) -> jax.Array:
    """Placeholder correction for 1-2 bit HARQ-ACK payloads on PUSCH.

    The demodulator descrambles every position; the spec's x/y placeholders
    (TS 38.211 scrambling special cases) must then be reverted on the ACK
    REs (reference ulsch_demultiplex_impl.cpp on_uci_placeholder_1bit/2bit):

    - 1 bit/RE group [b, y, x..]: out[1] flips iff c0 ^ c1; out[2:] flip
      iff their own c (reverting the descramble on known-'1' x bits).
    - 2 bits [b0, b1, x..]: out[0:2] copied; out[2:] flip iff own c.

    ack_llrs, scr_bits: (..., G_ack) with G_ack a multiple of Qm.
    """
    if nof_ack_bits > 2 or qm == 1:
        return ack_llrs
    g = ack_llrs.shape[-1]
    grp = ack_llrs.reshape(ack_llrs.shape[:-1] + (g // qm, qm))
    c = scr_bits.reshape(scr_bits.shape[:-1] + (g // qm, qm)).astype(jnp.int32)
    flip = jnp.zeros_like(c)
    if nof_ack_bits == 1:
        flip = flip.at[..., 1].set(c[..., 0] ^ c[..., 1])
    if qm > 2:
        flip = flip.at[..., 2:].set(c[..., 2:])
    out = jnp.where(flip == 1, -grp, grp)
    return out.reshape(ack_llrs.shape)


def decode_csi_two_step(csi1_llrs, csi2_llrs, csi_cfg):
    """Two-step CSI decode with part-1-dependent part-2 sizing.

    The reference decodes CSI part 1, feeds it through
    uci_part2_size_calculator, and only then decodes part 2 at the derived
    size (pusch_processor_impl's on_csi_part1 -> part2 flow).  Batched
    equivalent: part 2 is decoded for EVERY size the correspondence allows
    (one tiny short-block/polar detect per distinct size, all in one
    program) and the decoded RI selects the result — branch-free instead
    of host round-tripping on the part-1 payload.

    Returns dict with csi1 (bits, ok), csi2 (bits padded to the max size,
    ok), rank (traced int32), and nof_csi2_bits (traced int32).
    """
    import jax.numpy as jnp

    from ..ran import csi as csi_mod

    n1 = csi_mod.part1_bitwidth(csi_cfg)
    bits1, ok1 = uci_mod.decode_uci(csi1_llrs.astype(jnp.float32), n1)
    out = {"csi1": (bits1, ok1)}

    corr = csi_mod.part2_correspondence(csi_cfg)
    if corr is None or csi2_llrs is None:
        return out
    ri_off, ri_w, sizes = corr
    # RI field value (MSB-first) from the decoded part-1 payload.
    v = jnp.int32(0)
    for j in range(ri_w):
        v = (v << 1) | bits1[ri_off + j].astype(jnp.int32)
    v = jnp.clip(v, 0, len(sizes) - 1)

    max_size = max(sizes)
    cand_bits = []
    cand_ok = []
    for s in sorted(set(sizes)):
        b, ok = uci_mod.decode_uci(csi2_llrs.astype(jnp.float32), s)
        pad = max_size - s
        if pad:
            b = jnp.concatenate([b, jnp.zeros((pad,), b.dtype)])
        cand_bits.append(b)
        cand_ok.append(ok)
    distinct = sorted(set(sizes))
    size_of_v = jnp.asarray([sizes[i] for i in range(len(sizes))], jnp.int32)
    idx_of_v = jnp.asarray([distinct.index(sizes[i]) for i in range(len(sizes))],
                           jnp.int32)
    sel = idx_of_v[v]
    bits2 = jnp.select([sel == i for i in range(len(distinct))], cand_bits)
    ok2 = jnp.select([sel == i for i in range(len(distinct))], cand_ok)
    out["csi2"] = (bits2, ok2)
    out["rank"] = v + 1
    out["nof_csi2_bits"] = size_of_v[v]
    return out
