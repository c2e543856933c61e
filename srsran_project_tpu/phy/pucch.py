"""PUCCH formats 0 and 1: generation (UE side, for tests) and detection
(gNB side).

Counterpart of the reference's pucch_detector_format0/format1
(lib/phy/upper/channel_processors/pucch/pucch_detector_format0.cpp,
pucch_detector_format1.cpp).  Format 0 detection is a correlation against
the candidate cyclic shifts; format 1 estimates the channel from the DM-RS
symbols and coherently combines the data symbols.  All sequence/shift
geometry is static; only the received grid is traced.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import scrambling, sequences
from ..ran.constants import NRE


@dataclasses.dataclass(frozen=True)
class PucchFormat0Config:
    prb: int  # PRB index in the grid
    start_symbol: int
    nof_symbols: int  # 1 or 2
    initial_cyclic_shift: int  # m0
    n_id: int  # hopping id
    slot_in_frame: int = 0
    nof_harq_bits: int = 1  # 0 (SR only), 1 or 2
    # Intra-slot frequency hopping: PRB of the second symbol (TS 38.213
    # 9.2.1; reference format0_configuration.second_hop_prb).
    second_hop_prb: int | None = None
    # True when this PUCCH occasion coincides with an SR opportunity: the
    # UE signals positive SR by shifting m_cs (+3 for 1 HARQ bit, +1 for 2;
    # TS 38.213 9.2.4 / 38.211 Table 6.3.2.3.1-1), doubling the candidate
    # set the detector searches.
    sr_opportunity: bool = False
    nof_grid_sc: int = 624


@dataclasses.dataclass(frozen=True)
class PucchFormat1Config:
    prb: int
    start_symbol: int
    nof_symbols: int  # 4..14
    initial_cyclic_shift: int
    occ_index: int  # time-domain OCC index
    n_id: int
    slot_in_frame: int = 0
    nof_harq_bits: int = 1
    nof_grid_sc: int = 624
    # Intra-slot frequency hopping: PRB of the second hop (symbols
    # nof_symbols//2 onward); OCC spreading restarts per hop (TS 38.211
    # 6.3.2.4.2; reference format1_configuration.second_hop_prb).
    second_hop_prb: int | None = None


def _ncs_values(n_id: int, slot: int, symbols) -> list[int]:
    """n_cs(n_s, l) per TS 38.211 §6.3.2.2.2 from the cell PRN sequence."""
    out = []
    seq = scrambling.gold_ref(n_id % (1 << 31), 8 * 14 * (slot + 1))
    for l in symbols:
        bits = seq[8 * (14 * slot + l) : 8 * (14 * slot + l) + 8]
        out.append(int(sum(int(b) << m for m, b in enumerate(bits))))
    return out


def _alpha(m0: int, m_cs: int, n_cs: int) -> float:
    return 2.0 * np.pi / NRE * ((m0 + m_cs + n_cs) % NRE)


# m_cs per HARQ value (TS 38.213 Table 9.2.3-3/9.2.3-4; golden-tested
# against the reference detector dictionaries,
# pucch_detector_format0.cpp:45-52).
_MCS_1BIT = {0: 0, 1: 6}
# value = b0 + 2*b1: (0,0)->0, (1,0)->9, (0,1)->3, (1,1)->6.
_MCS_2BIT = {0: 0, 1: 9, 3: 6, 2: 3}


def _f0_candidates(cfg: PucchFormat0Config):
    if cfg.nof_harq_bits == 0:
        return [0]
    if cfg.nof_harq_bits == 1:
        base = [_MCS_1BIT[v] for v in range(2)]
        sr_shift = 3
    else:
        base = [_MCS_2BIT[v] for v in range(4)]
        sr_shift = 1
    if cfg.sr_opportunity:
        return base + [(m + sr_shift) % 12 for m in base]
    return base


def format0_generate(cfg: PucchFormat0Config, harq_value: int,
                     sr: bool = False) -> np.ndarray:
    """UE-side reference signal for tests: (nof_symbols, 12) complex64.

    sr: positive scheduling request (requires cfg.sr_opportunity)."""
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols)
    ncs = _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)
    cands = _f0_candidates(cfg)
    idx = harq_value if cfg.nof_harq_bits else 0
    if sr:
        assert cfg.sr_opportunity and cfg.nof_harq_bits
        idx += len(cands) // 2
    m_cs = cands[idx] if cfg.nof_harq_bits else 0
    out = []
    for i, _ in enumerate(syms):
        alpha = _alpha(cfg.initial_cyclic_shift, m_cs, ncs[i])
        out.append(np.asarray(sequences.generate(u, v, NRE, jnp.float32(alpha))))
    return np.stack(out).astype(np.complex64)


# DTX decision thresholds, calibrated on 4000 noise-only draws per format
# (tests/test_pucch_stats.py asserts the operating points): false-alarm
# rate < 0.1% (max observed DTX metric: F0 0.395, F1 rho 0.707) while the
# 3 dB single-port operating point detects with ~0 missed detections
# (min observed signal metric: F0 0.449, F1 rho 0.810).  The reference
# validates its PUCCH demodulators at spec operating points the same way
# (detector statistics per format).
F0_DTX_THRESHOLD = 0.42
F1_DTX_THRESHOLD = 0.75


@functools.partial(jax.jit, static_argnames=("cfg",))
def format0_detect(grid: jax.Array, cfg: PucchFormat0Config):
    """Detect PUCCH F0 from (nof_rx_ports, nsym, nsc) grid.

    Returns (harq_value (int32), metric (f32), per-candidate powers)."""
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    ncs = _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)
    # Intra-slot frequency hopping: symbols after the first move to
    # second_hop_prb (reference pucch_detector_format0.cpp:150-155).
    prbs = [cfg.prb] + [cfg.second_hop_prb if cfg.second_hop_prb is not None
                        else cfg.prb] * (cfg.nof_symbols - 1)
    y = jnp.stack(
        [grid[:, s, prbs[i] * NRE : (prbs[i] + 1) * NRE] for i, s in enumerate(syms)],
        axis=1)  # (P, S, 12)

    cands = _f0_candidates(cfg)
    powers = []
    total = (jnp.abs(y) ** 2).sum() + 1e-12
    for m_cs in cands:
        corr = 0.0
        for i in range(len(syms)):
            alpha = _alpha(cfg.initial_cyclic_shift, m_cs, ncs[i])
            ref = sequences.generate(u, v, NRE, jnp.float32(alpha))
            # Coherent correlation per port/symbol, power-combined.
            c = (y[:, i, :] * jnp.conj(ref)).sum(axis=-1)
            corr = corr + (jnp.abs(c) ** 2).sum()
        powers.append(corr)
    powers = jnp.stack(powers)
    best = jnp.argmax(powers)
    # Ideal noiseless signal gives metric 1: each symbol contributes
    # |12 h|^2 = 144 |h|^2 to the winning correlation and 12 |h|^2 to total.
    metric = powers[best] / (total * NRE)
    return best.astype(jnp.int32), metric, powers


# Time-domain OCC w_i(m) for format 1 (TS 38.211 Table 6.3.2.4.1-2):
# w_i(m) = exp(j 2 pi i m / N_sf).
def _occ(n_sf: int, i: int) -> np.ndarray:
    m = np.arange(n_sf)
    return np.exp(2j * np.pi * i * m / n_sf).astype(np.complex64)


def _f1_hops(cfg: PucchFormat1Config):
    """Per-hop (syms, dmrs_syms, data_syms, prb).  One hop without
    frequency hopping; with hopping, the second half of the allocation
    moves to second_hop_prb and OCC spreading restarts."""
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    if cfg.second_hop_prb is None:
        groups = [(syms, cfg.prb)]
    else:
        half = cfg.nof_symbols // 2
        groups = [(syms[:half], cfg.prb), (syms[half:], cfg.second_hop_prb)]
    hops = []
    for hop_syms, prb in groups:
        dmrs = [l for l in hop_syms if (l - cfg.start_symbol) % 2 == 0]
        data = [l for l in hop_syms if (l - cfg.start_symbol) % 2 == 1]
        hops.append((hop_syms, dmrs, data, prb))
    return hops


def _f1_geometry(cfg: PucchFormat1Config):
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    dmrs_syms = syms[0::2]
    data_syms = syms[1::2]
    return syms, dmrs_syms, data_syms


def format1_generate(cfg: PucchFormat1Config, bits: np.ndarray) -> np.ndarray:
    """UE-side signal for tests: (nof_symbols, 12) complex64 (data+DM-RS).

    With frequency hopping the caller places row i at the PRB given by
    _f1_hops; the OCC restarts on the second hop."""
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    ncs = dict(zip(syms, _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)))
    if cfg.nof_harq_bits == 1:
        d = (1.0 - 2.0 * bits[0]) / np.sqrt(2) * (1 + 1j)
    else:
        d = ((1.0 - 2.0 * bits[0]) + 1j * (1.0 - 2.0 * bits[1])) / np.sqrt(2)
    out = np.zeros((len(syms), NRE), dtype=np.complex64)
    for hop_syms, dmrs_syms, data_syms, _prb in _f1_hops(cfg):
        w_data = _occ(max(len(data_syms), 1), cfg.occ_index)
        w_dmrs = _occ(max(len(dmrs_syms), 1), cfg.occ_index)
        for i, l in enumerate(data_syms):
            alpha = _alpha(cfg.initial_cyclic_shift, 0, ncs[l])
            seq = np.asarray(sequences.generate(u, v, NRE, jnp.float32(alpha)))
            out[syms.index(l)] = d * w_data[i] * seq
        for i, l in enumerate(dmrs_syms):
            alpha = _alpha(cfg.initial_cyclic_shift, 0, ncs[l])
            seq = np.asarray(sequences.generate(u, v, NRE, jnp.float32(alpha)))
            out[syms.index(l)] = w_dmrs[i] * seq
    return out


@functools.partial(jax.jit, static_argnames=("cfg",))
def format1_detect(grid: jax.Array, cfg: PucchFormat1Config):
    """Detect PUCCH F1 HARQ bits from (P, nsym, nsc) grid.

    Returns (bits (nof_harq_bits,) uint8, llrs, snr-like metric)."""
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    ncs = dict(zip(syms, _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)))

    def despread(l_list, occ, prb):
        sc = slice(prb * NRE, (prb + 1) * NRE)
        acc = 0.0
        for i, l in enumerate(l_list):
            alpha = _alpha(cfg.initial_cyclic_shift, 0, ncs[l])
            seq = sequences.generate(u, v, NRE, jnp.float32(alpha))
            y = grid[:, l, sc]  # (P, 12)
            acc = acc + (y * jnp.conj(seq)) * np.conj(occ[i])
        return acc / max(len(l_list), 1)  # (P, 12)

    # Per hop: coherent despreading within the hop; contributions combine
    # additively across hops (the channel differs per hop, but d is common
    # so z.h* adds coherently — reference metrics_hop0 + metrics_hop1).
    corr = 0.0
    h_pow = 0.0
    z_pow = 0.0
    for hop_syms, dmrs_syms, data_syms, prb in _f1_hops(cfg):
        h = despread(dmrs_syms, _occ(max(len(dmrs_syms), 1), cfg.occ_index), prb)
        z = despread(data_syms, _occ(max(len(data_syms), 1), cfg.occ_index), prb)
        corr = corr + (z * jnp.conj(h)).sum()
        h_pow = h_pow + (jnp.abs(h) ** 2).sum()
        z_pow = z_pow + (jnp.abs(z) ** 2).sum()
    # DTX statistic: normalized correlation coefficient between the DM-RS
    # and data despread estimates, in [0, 1].  A matched transmission gives
    # ~1 (both carry the same h per subcarrier); noise-only input
    # decorrelates the two halves.  Thresholded against F1_DTX_THRESHOLD.
    rho = jnp.abs(corr) / jnp.sqrt(h_pow * z_pow + 1e-24)
    if cfg.nof_harq_bits == 1:
        proj = (corr.real + corr.imag) / np.sqrt(2)
        bits = jnp.asarray([proj < 0], jnp.uint8)
        llrs = jnp.asarray([proj])
    else:
        bits = jnp.asarray([corr.real < 0, corr.imag < 0], jnp.uint8)
        llrs = jnp.stack([corr.real, corr.imag]) / np.sqrt(2)
    return bits, llrs, rho


@functools.partial(jax.jit, static_argnames=("cfg",))
def format1_detect_batch(grid: jax.Array, cfg: PucchFormat1Config):
    """Detect ALL multiplexed F1 transmissions on one resource at once.

    Counterpart of the reference's format1_batch_configuration path
    (pucch_detector_format1.cpp): despreading every initial cyclic shift
    is a 12-point DFT across subcarrier phase (spreading in frequency uses
    DFT columns) and despreading every time-domain OCC is a DFT across the
    hop's symbols — so the whole (12 x N_occ) candidate bank is two small
    batched FFTs, one batched program (the per-UE API calls one
    jit per UE; this runs one program for the whole resource).

    cfg's initial_cyclic_shift/occ_index are ignored.  Returns dict with
    ``corr`` (12, max_occ) complex correlations, ``rho`` (12, max_occ) DTX
    statistics, and ``bits2`` (12, max_occ, 2) hard bits (use [..., :1]
    for 1-bit candidates).  Like the reference batch API, consume only the
    entries the scheduler actually allocated: rho discriminates signal
    from noise per entry, but sidelobes of OTHER active transmissions can
    raise rho on unallocated cells.
    """
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    ncs = dict(zip(syms, _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)))

    hops = _f1_hops(cfg)
    max_occ = max(len(h[2]) for h in hops)  # data symbols bound the OCC set

    corr = 0.0
    h_pow = 0.0
    z_pow = 0.0
    for hop_syms, dmrs_syms, data_syms, prb in hops:
        sc = slice(prb * NRE, (prb + 1) * NRE)

        def shift_bank(l_list):
            """(P, nsym_part, 12): per-symbol LS against every cyclic
            shift = 12-point DFT of y * conj(r_alpha0) over subcarriers."""
            zs = []
            for l in l_list:
                alpha = _alpha(0, 0, ncs[l])
                seq = sequences.generate(u, v, NRE, jnp.float32(alpha))
                y = grid[:, l, sc]  # (P, 12)
                z = y * jnp.conj(seq)
                zs.append(jnp.fft.fft(z, axis=-1) / NRE)  # (P, 12 shifts)
            return jnp.stack(zs, axis=1)  # (P, nsym_part, 12)

        # OCC despreading across symbols of the hop = DFT over symbol index
        # (w_i(m) = e^{j2pi i m / n_sf}); pad with zeros / truncate to
        # max_occ rows.  Truncation matters for odd nof_symbols (5,7,...):
        # the DM-RS part then has more symbols than the data part, but the
        # OCC candidate set is bounded by the data-symbol count.
        def occ_bank(bank, n_sf):
            f = jnp.fft.fft(bank, axis=1) / max(n_sf, 1)  # (P, n_sf, 12)
            pad = max_occ - f.shape[1]
            if pad > 0:
                f = jnp.concatenate(
                    [f, jnp.zeros(f.shape[:1] + (pad,) + f.shape[2:], f.dtype)], axis=1)
            return f[:, :max_occ]  # (P, max_occ, 12)

        hb = occ_bank(shift_bank(dmrs_syms), len(dmrs_syms))
        zb = occ_bank(shift_bank(data_syms), len(data_syms))
        corr = corr + (zb * jnp.conj(hb)).sum(axis=0)  # (max_occ, 12)
        h_pow = h_pow + (jnp.abs(hb) ** 2).sum(axis=0)
        z_pow = z_pow + (jnp.abs(zb) ** 2).sum(axis=0)

    corr = corr.T  # (12 shifts, max_occ)
    rho = jnp.abs(corr) / jnp.sqrt((h_pow * z_pow).T + 1e-24)
    bits2 = jnp.stack([(corr.real < 0), (corr.imag < 0)], axis=-1).astype(jnp.uint8)
    return {"corr": corr, "rho": rho, "bits2": bits2}
