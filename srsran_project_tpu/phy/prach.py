"""PRACH preamble generation and detection (TS 38.211 §6.3.3).

Counterpart of the reference's prach_generator_impl (ZC roots,
lib/phy/upper/channel_processors/prach_generator_impl.cpp:194) and
prach_detector_generic_impl (freq-domain root correlation + IDFT power
delay profile + per-shift windowed peak search,
lib/phy/upper/channel_processors/prach_detector_generic_impl.cpp:80-260).

Batched design: all 64 preamble hypotheses of an occasion are evaluated in one
batched program — the per-root correlations IDFT together as one batch, the
per-shift windows are precomputed gather masks, and the detection metric is
a vectorized peak/noise ratio.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

# Zero-correlation-zone -> N_CS, long preambles, unrestricted set
# (TS 38.211 Table 6.3.3.1-5).
NCS_LONG_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419)
# Short preambles (TS 38.211 Table 6.3.3.1-7).
NCS_SHORT = (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69)


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    l_ra: int = 839  # 839 (long) or 139 (short)
    root_sequence_index: int = 0  # logical start index -> physical roots used in order
    zero_correlation_zone: int = 1
    nof_rx_ports: int = 1
    dft_size: int = 1024  # IDFT size for the power delay profile
    # Detection threshold (peak power over noise floor).  None = CFAR:
    # solved analytically from the noise model for target_pfa per occasion
    # (the role of the reference's prach_detector_generic_thresholds.cpp
    # per-(format, zcz, ports) table, derived instead of tabulated).
    detect_threshold: float | None = None
    target_pfa: float = 1e-3

    @property
    def n_cs(self) -> int:
        table = NCS_LONG_UNRESTRICTED if self.l_ra == 839 else NCS_SHORT
        return table[self.zero_correlation_zone]

    @property
    def nof_shifts(self) -> int:
        return self.l_ra // self.n_cs if self.n_cs else 1

    @property
    def nof_roots(self) -> int:
        return -(-64 // self.nof_shifts)


def zc_root(u: int, l_ra: int) -> np.ndarray:
    """Time-domain Zadoff-Chu root x_u(n) = exp(-j pi u n(n+1) / L_RA)."""
    n = np.arange(l_ra, dtype=np.float64)
    return np.exp(-1j * np.pi * u * n * (n + 1) / l_ra)


@functools.lru_cache(maxsize=None)
def _root_fd(u: int, l_ra: int) -> np.ndarray:
    """Frequency-domain root sequence (complex64)."""
    return np.fft.fft(zc_root(u, l_ra)).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def _root_tables():
    import os

    d = np.load(os.path.join(os.path.dirname(__file__), "_prach_roots.npz"))
    return d["long"], d["short"]


def physical_root(logical_index: int, l_ra: int) -> int:
    """Logical -> physical root sequence number u (TS 38.211
    Tables 6.3.3.1-3 / 6.3.3.1-4)."""
    long_t, short_t = _root_tables()
    table = long_t if l_ra == 839 else short_t
    return int(table[logical_index % len(table)])


def _gamma_sf(x: float, p: int) -> float:
    """Survival function of Gamma(shape=p, scale=1) for integer p:
    exp(-x) * sum_{k<p} x^k / k!."""
    import math

    s = 0.0
    term = 1.0
    for k in range(p):
        if k:
            term *= x / k
        s += term
    return math.exp(-x) * s


def threshold_for(cfg: PrachConfig) -> float:
    """CFAR detection threshold for target_pfa per occasion.

    Noise model: each delay-domain PDP bin of the per-root correlation is
    exponential; summing P rx ports gives Gamma(P).  The metric normalizes
    by the mean of the port-summed PDP (= P x bin mean), so metric*P ~
    Gamma(P) under H0.  With N_eff = 64 preambles x window bins candidate
    bins, solve N_eff * SF_Gamma(P)(P*T) = pfa by bisection.
    """
    nfft = cfg.dft_size
    full_win = max(1, int(cfg.n_cs * nfft / cfg.l_ra)) if cfg.n_cs else nfft
    win = max(1, int(0.8 * full_win))
    n_eff = 64 * win
    p = cfg.nof_rx_ports
    target = cfg.target_pfa / n_eff
    lo, hi = 0.0, 200.0 * p
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _gamma_sf(mid, p) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) / p


def generate_preamble(cfg: PrachConfig, preamble_index: int) -> np.ndarray:
    """UE-side freq-domain preamble (L_RA,) for tests."""
    v = preamble_index % cfg.nof_shifts
    root_i = preamble_index // cfg.nof_shifts
    u = physical_root(cfg.root_sequence_index + root_i, cfg.l_ra)
    cv = v * cfg.n_cs
    x = np.roll(zc_root(u, cfg.l_ra), -cv)  # x_u((n + C_v) mod L_RA)
    return np.fft.fft(x).astype(np.complex64)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect(rx_fd: jax.Array, cfg: PrachConfig):
    """Detect preambles from the freq-domain PRACH window.

    rx_fd: (nof_rx_ports, L_RA) complex64 — the demodulated preamble
           subcarriers (one occasion, coherently averaged symbols).
    Returns dict: detected (64,) bool, metric (64,) f32, ta_samples (64,)
    f32 (delay at dft_size resolution).
    """
    lr = cfg.l_ra
    nfft = cfg.dft_size
    nshift = cfg.nof_shifts
    nroot = cfg.nof_roots

    roots = np.stack(
        [
            _root_fd(physical_root(cfg.root_sequence_index + i, lr), lr)
            for i in range(nroot)
        ]
    )  # (nroot, L_RA)

    # Correlate: per root, conj-multiply and IDFT to the delay domain.
    c = rx_fd[None, :, :] * jnp.conj(jnp.asarray(roots))[:, None, :]  # (nroot, P, L)
    pad = jnp.zeros((nroot, rx_fd.shape[0], nfft - lr), jnp.complex64)
    cp = jnp.concatenate([c, pad], axis=-1)
    pdp = jnp.abs(jnp.fft.ifft(cp, axis=-1)) ** 2  # (nroot, P, nfft)
    pdp = pdp.sum(axis=1)  # combine ports

    # Shift windows: preamble (root i, shift v) = x_u(n + v*N_CS), whose
    # correlation peak sits at delay (d - v*N_CS*nfft/L_RA) mod nfft for a
    # channel delay d in [0, N_CS*nfft/L_RA).
    # Cap the usable delay span at 0.8 of the shift window (the reference
    # limits max TA the same way) so fractional-bin leakage from the
    # neighboring shift's zero-delay peak stays outside every window.
    full_win = max(1, int(cfg.n_cs * nfft / lr)) if cfg.n_cs else nfft
    win = max(1, int(0.8 * full_win))
    starts = ((lr - np.arange(nshift) * cfg.n_cs) * nfft // lr) % nfft
    idx = (starts[:, None] + np.arange(win)[None, :]) % nfft  # (nshift, win)
    windows = pdp[:, jnp.asarray(idx)]  # (nroot, nshift, win)

    peak = windows.max(axis=-1)
    peak_pos = jnp.argmax(windows, axis=-1)
    mean_all = pdp.mean(axis=-1, keepdims=True)  # per root noise floor
    metric = peak / (mean_all + 1e-12)

    flat_metric = metric.reshape(-1)[:64]
    flat_pos = peak_pos.reshape(-1)[:64]
    thr = cfg.detect_threshold if cfg.detect_threshold is not None else threshold_for(cfg)
    detected = flat_metric > thr
    ta = flat_pos.astype(jnp.float32)
    return {"detected": detected, "metric": flat_metric, "ta_samples": ta}


# ---------------------------------------------------------------------------
# Reference-exact generation (conformance surface)
# ---------------------------------------------------------------------------

# Long formats use L_RA = 839 (RA SCS 1.25 kHz for 0-2, 5 kHz for 3);
# short formats use L_RA = 139 (TS 38.211 Table 6.3.3.1-1/2).
_LONG_FORMATS = {"0": 1250, "1": 1250, "2": 1250, "3": 5000}


@functools.lru_cache(maxsize=1)
def _std_tables():
    import os

    d = np.load(os.path.join(os.path.dirname(__file__), "_prach_tables.npz"))
    return {k: d[k] for k in d.files}


def prach_ncs(fmt: str, zero_correlation_zone: int, restricted: str = "unrestricted") -> int:
    """N_CS from TS 38.211 Tables 6.3.3.1-5/6/7 (reference
    lib/ran/prach/prach_cyclic_shifts.cpp).  Raises on reserved entries."""
    t = _std_tables()
    if fmt in _LONG_FORMATS:
        base = "ncs_1_25" if _LONG_FORMATS[fmt] == 1250 else "ncs_5"
        key = {"unrestricted": f"{base}_unrestricted",
               "type_a": f"{base}_type_a",
               "type_b": f"{base}_type_b"}[restricted]
    else:
        if restricted != "unrestricted":
            raise ValueError("restricted sets apply to long preambles only")
        key = "ncs_short_unrestricted"
    val = int(t[key][zero_correlation_zone])
    if val == int(t["ncs_reserved_marker"][0]):
        raise ValueError(f"reserved N_CS for format {fmt} zcz {zero_correlation_zone}")
    return val


def physical_root_ref(logical_index: int, l_ra: int) -> int:
    """Logical -> physical root (TS 38.211 Tables 6.3.3.1-3/4), verified
    against the reference generator."""
    t = _std_tables()
    table = t["long_root_map"] if l_ra == 839 else t["short_root_map"]
    return int(table[logical_index % len(table)])


def generate_preamble_ref(
    fmt: str,
    root_sequence_index: int,
    preamble_index: int,
    zero_correlation_zone: int,
    restricted: str = "unrestricted",
) -> np.ndarray:
    """Frequency-domain preamble y_u,v — bit-parity surface vs the
    reference prach_generator_impl::generate (unnormalized DFT of the
    cyclic-shifted time ZC root; root/shift selection per TS 38.211
    §6.3.3.1)."""
    l_ra = 839 if fmt in _LONG_FORMATS else 139
    n_cs = prach_ncs(fmt, zero_correlation_zone, restricted)
    logical = root_sequence_index + preamble_index
    shift = 0
    if n_cs != 0:
        nof_seq_per_root = l_ra // n_cs
        logical = root_sequence_index + preamble_index // nof_seq_per_root
        shift = (preamble_index % nof_seq_per_root) * n_cs
    u = physical_root_ref(logical, l_ra)
    x = zc_root(u, l_ra)
    if shift:
        x = np.roll(x, -shift)
    return np.fft.fft(x).astype(np.complex64)


# CP length per format in units of kappa (= 64 Tc) and symbol counts
# (reference lib/ran/prach/prach_preamble_information.cpp; TS 38.211
# Table 6.3.3.1-1/2).  Short-format entries are >> numerology.
_PREAMBLE_INFO = {
    # fmt: (cp_kappa, nof_symbols, ra_scs_hz-or-None-for-short)
    "0": (3168, 1, 1250.0),
    "1": (21024, 2, 1250.0),
    "2": (4688, 4, 1250.0),
    "3": (3168, 4, 5000.0),
    "A1": (288, 2, None),
    "A2": (576, 4, None),
    "A3": (864, 6, None),
    "B1": (216, 2, None),
    "B4": (936, 12, None),
    "C0": (1240, 1, None),
    "C2": (2048, 4, None),
}
_KAPPA_S = 64.0 / (480000.0 * 4096.0)
_SCS_ENUM = {1250.0: 0, 5000.0: 1, 15000.0: 2, 30000.0: 3, 60000.0: 4, 120000.0: 5}
_FMT_ENUM = {"0": 0, "1": 1, "2": 2, "3": 3, "A1": 10, "A2": 11, "A3": 12,
             "B1": 13, "B4": 16, "C0": 30, "C2": 31}


@functools.lru_cache(maxsize=1)
def _threshold_table():
    import os

    d = np.load(os.path.join(os.path.dirname(__file__), "_prach_thresholds.npz"))
    return d["table"]


def detection_threshold_ref(
    fmt: str, nof_rx_ports: int, zero_correlation_zone: int,
    ra_scs_hz: float, combine_symbols: bool = True,
) -> tuple[float, int]:
    """(threshold, window margin) from the reference's validated table
    (prach_detector_generic_thresholds.cpp), with its fallback defaults
    for uncovered combinations."""
    t = _threshold_table()
    key = (nof_rx_ports, _SCS_ENUM[ra_scs_hz], _FMT_ENUM[fmt],
           zero_correlation_zone, 1 if combine_symbols else 0)
    for row in t:
        if tuple(int(v) for v in row[:5]) == key:
            return float(row[5]), int(row[6])
    if fmt in _LONG_FORMATS:
        return 2.0, 5
    return 0.3, 12


def detect_ref(
    rx_fd: np.ndarray,
    fmt: str,
    root_sequence_index: int,
    zero_correlation_zone: int,
    nof_rx_ports: int | None = None,
    dft_size: int = 1024,
    ra_scs_hz: float | None = None,
):
    """Reference-parity PRACH detection
    (prach_detector_generic_impl.cpp:80-360).

    rx_fd: (ports, nof_symbols, L_RA) freq-domain preamble symbols.
    Returns a list of dicts {preamble_index, metric, ta_s, power} for
    detected preambles, using the validated threshold/margin table.
    """
    rx_fd = np.asarray(rx_fd)
    ports, nof_symbols, l_ra = rx_fd.shape
    if nof_rx_ports is None:
        nof_rx_ports = ports
    cp_kappa, _fmt_syms, scs_default = _PREAMBLE_INFO[fmt]
    if ra_scs_hz is None:
        ra_scs_hz = scs_default if scs_default else 15000.0
    n_cs = prach_ncs(fmt, zero_correlation_zone)
    nof_shifts = min(64, l_ra // n_cs) if n_cs else 1
    nof_sequences = -(-64 // nof_shifts)

    cp_s = cp_kappa * _KAPPA_S
    cp_prach = int(np.floor(cp_s * l_ra * ra_scs_hz))
    win_width = cp_prach if n_cs == 0 else min(n_cs, cp_prach)
    win_width = (win_width * dft_size) // l_ra
    max_delay = cp_prach if n_cs == 0 else min(max(n_cs, 1) - 1, cp_prach)
    max_delay = (max_delay * dft_size) // l_ra
    fs = dft_size * ra_scs_hz

    threshold, margin = detection_threshold_ref(
        fmt, nof_rx_ports, zero_correlation_zone, ra_scs_hz, True)

    results = []
    for i_seq in range(nof_sequences):
        root = generate_preamble_ref(fmt, root_sequence_index, i_seq * nof_shifts,
                                     zero_correlation_zone)
        num = np.zeros((nof_shifts, win_width))
        den = np.zeros((nof_shifts, win_width))
        for p in range(ports):
            combined = rx_fd[p].sum(axis=0)  # combine symbols
            no_root = combined * np.conj(root)
            # Half-spectrum swap into the IDFT (negative freqs low).
            buf = np.zeros(dft_size, np.complex128)
            half = l_ra // 2
            buf[: half + 1] = no_root[half:]
            buf[dft_size - half:] = no_root[:half]
            t = np.fft.ifft(buf) * dft_size  # unnormalized INVERSE DFT
            mod_sq = (np.abs(t) ** 2) / (dft_size * l_ra)
            for i_w in range(nof_shifts):
                start = (dft_size - (n_cs * i_w * dft_size) // l_ra) % dft_size
                idx = (start + np.arange(win_width)) % dft_size
                window = mod_sq[idx] * (dft_size / l_ra)
                ref_idx = (start - margin + np.arange(2 * margin + win_width)) % dft_size
                reference = float(mod_sq[ref_idx].sum())
                num[i_w] += window
                diff = reference - window
                diff[~np.isfinite(diff) | (diff == 0)] = 1e-9
                den[i_w] += diff
        metric = num / np.abs(den)
        for i_w in range(nof_shifts):
            pi = i_seq * nof_shifts + i_w
            if pi >= 64:
                continue
            d = int(np.argmax(metric[i_w]))
            peak = float(metric[i_w, d])
            if peak > threshold and d < 0.8 * max_delay:
                results.append({
                    "preamble_index": pi,
                    "metric": peak / threshold,
                    "ta_s": d / fs,
                    "power": float(num[i_w, d] / (nof_rx_ports * l_ra * nof_symbols * nof_symbols)),
                })
    return results
