"""Reference-parity port channel estimator as a jitted JAX program.

Same semantics as the NumPy oracle ``ops/estimator_ref.py`` (which is the
conformance surface against the reference's
port_channel_estimator_average_impl.cpp), re-expressed as a static-shape
JAX program so it is selectable as the PRODUCTION estimator in the PUSCH
chain (``PuschConfig.estimator="reference"``) — the same pattern as the
``mmse_ref`` equalizer and ``reference_i8`` demapper parity kernels:

  LS pilot match -> CFO estimate/compensation -> time-domain average (or
  per-DMRS-symbol LSE) -> CDM pair averaging -> raised-cosine smoothing
  with virtual edge pilots -> linear frequency interpolation -> noise
  variance / EPRE / RSRP / SNR -> TA via zero-padded IDFT peak with
  fractional refinement.

All pilot geometry, filter taps, interpolation index/weight maps and DFT
sizes are precomputed host-side per static config; the device program is
pure dense tensor math.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from . import estimator_ref as _oracle

NRE = 12
MAX_SINR_DB = 100.0


@dataclasses.dataclass(frozen=True)
class RefEstimatorConfig:
    scs_khz: int
    nof_prb: int
    first_symbol: int
    nof_symbols: int
    dmrs_symbol_mask: int
    re_pattern: tuple
    nof_layers: int = 1
    # RE pattern of CDM group 1 (layers 2-3); None = single group.  The
    # reference processes layer pairs with per-pair patterns
    # (port_channel_estimator_average_impl.cpp:256).
    re_pattern2: tuple | None = None
    scaling: float = 1.0
    smoothing: str = "filter"    # filter | mean | none
    td_strategy: str = "average"  # average | interpolate
    compensate_cfo: bool = True


@functools.lru_cache(maxsize=None)
def _constants(cfg: RefEstimatorConfig):
    """Host-side precomputation of every static quantity the jitted
    program needs (mirrors the oracle's scalar code paths exactly)."""
    mu = {15: 0, 30: 1, 60: 2, 120: 3}[cfg.scs_khz]
    dmrs_syms = tuple(s for s in range(14) if (cfg.dmrs_symbol_mask >> s) & 1)
    nof_cdm = (cfg.nof_layers + 1) // 2
    pats = [cfg.re_pattern if g == 0 else (cfg.re_pattern2 or cfg.re_pattern)
            for g in range(max(nof_cdm, 1))]
    re_idx_g = np.stack([np.concatenate(
        [rb * NRE + np.asarray(p) for rb in range(cfg.nof_prb)]
    ).astype(np.int32) for p in pats])  # (ncdm, Np)
    re_idx = re_idx_g[0]
    nof_pilots = len(re_idx)
    offset = int(cfg.re_pattern[0])
    stride = (int(cfg.re_pattern[1]) - offset) if len(cfg.re_pattern) > 1 else 1
    epochs = _oracle._symbol_start_epochs(14, mu)

    # RC filter taps + virtual-pilot count (helpers.cpp:84).
    taps = _oracle._rc_filter(cfg.nof_prb, stride)
    nof_v = min(_oracle.MAX_V_PILOTS, len(taps) // 2)
    if cfg.nof_prb == 1:
        nof_v = nof_pilots // cfg.nof_prb

    # Linear-interpolation map per layer: run the oracle's loop
    # symbolically (per CDM-group offset) to get (i0, i1, w) per output
    # RE — exact semantics by construction.
    nof_subc = cfg.nof_prb * NRE

    def _interp_map(off):
        i0 = np.zeros(nof_subc, np.int32)
        i1 = np.zeros(nof_subc, np.int32)
        w = np.zeros(nof_subc, np.float32)
        i0[: off + 1] = 0
        i1[: off + 1] = 0
        i_out, i_in = off, 0
        while i_out + stride < nof_subc and i_in + 1 < nof_pilots:
            for k in range(1, stride + 1):
                i0[i_out + k] = i_in
                i1[i_out + k] = i_in + 1
                w[i_out + k] = k / stride
            i_out += stride
            i_in += 1
        last = min(i_in, nof_pilots - 1)
        i0[i_out + 1 :] = last
        i1[i_out + 1 :] = last
        w[i_out + 1 :] = 0.0
        return i0, i1, w

    maps_g = [_interp_map(int(p[0])) for p in pats]
    nlay = max(cfg.nof_layers, 1)
    i0 = np.stack([maps_g[min(l // 2, len(maps_g) - 1)][0] for l in range(nlay)])
    i1 = np.stack([maps_g[min(l // 2, len(maps_g) - 1)][1] for l in range(nlay)])
    w = np.stack([maps_g[min(l // 2, len(maps_g) - 1)][2] for l in range(nlay)])

    # TA correlator geometry (time_alignment_estimator_dft_impl).
    pat = tuple(cfg.re_pattern)
    if pat == _oracle._RE_PATTERN_FULL:
        ta_stride, ta_mask = 1, None
    elif pat in (_oracle._RE_PATTERN_PUSCH0, _oracle._RE_PATTERN_PUSCH1):
        ta_stride, ta_mask = 2, None
    elif pat == _oracle._RE_PATTERN_PUCCH_F2:
        ta_stride, ta_mask = 3, None
    else:
        ta_stride, ta_mask = 1, re_idx
    if ta_mask is not None:
        lo, hi = int(ta_mask.min()), int(ta_mask.max())
        nof_required = hi - lo + 1
        ta_positions = (ta_mask - lo).astype(np.int32)
    else:
        nof_required = nof_pilots
        ta_positions = np.arange(nof_pilots, dtype=np.int32)
    n = (nof_required * _oracle._MAX_DFT) // _oracle._MAX_NOF_RE
    dft_size = max(_oracle._MIN_DFT, 1 << max(0, int(np.ceil(np.log2(max(n, 1))))))
    fs = dft_size * cfg.scs_khz * 1000.0 * ta_stride
    kappa_s = 1.0 / (480000.0 * 4096.0)
    half_cp = 144.0 * 64.0 * kappa_s / (2 ** (mu + 1))
    max_ta_samples = int(np.floor(half_cp * fs))

    return dict(
        dmrs_syms=dmrs_syms, re_idx=re_idx, re_idx_g=re_idx_g,
        offset=offset, stride=stride,
        epochs=epochs.astype(np.float64), taps=taps.astype(np.float32),
        nof_v=nof_v, interp=(i0, i1, w), dft_size=dft_size, fs=fs,
        max_ta_samples=max_ta_samples, ta_positions=ta_positions,
        nof_subc=nof_subc,
    )


def _v_pilots(p_abs, p_arg, is_start: bool):
    """Virtual-pilot extrapolation (helpers.cpp:310) on (.., n) arrays."""
    n = p_abs.shape[-1]
    xs = jnp.arange(n, dtype=jnp.float32)
    mean_x = (n * (n - 1)) / 2.0 / n
    norm_x_sq = (n - 1) * n * (2 * n - 1) / 6.0
    denom = norm_x_sq - n * mean_x * mean_x

    def fit(v):
        mean_v = jnp.mean(v, axis=-1, keepdims=True)
        slope = (jnp.sum(v * xs, axis=-1, keepdims=True) - mean_x * mean_v * n) / denom
        icpt = mean_v - slope * mean_x
        return slope, icpt

    s_abs, i_abs = fit(p_abs)
    s_arg, i_arg = fit(p_arg)
    iv = xs + (-n if is_start else n)
    rho = s_abs * iv + i_abs
    phase = s_arg * iv + i_arg + jnp.where(rho > 0, 0.0, np.pi)
    return jnp.abs(rho) * jnp.exp(1j * phase.astype(jnp.float32))


def _fd_smooth(p, cfg: RefEstimatorConfig, c):
    """Frequency smoothing of (..., Np) pilot estimates."""
    if cfg.smoothing == "mean":
        return jnp.broadcast_to(jnp.mean(p, axis=-1, keepdims=True), p.shape)
    if cfg.smoothing == "none":
        return p
    nof_v = c["nof_v"]
    taps = jnp.asarray(c["taps"])
    head = _v_pilots(jnp.abs(p[..., :nof_v]),
                     jnp.unwrap(jnp.angle(p[..., :nof_v]), axis=-1), True)
    tail = _v_pilots(jnp.abs(p[..., -nof_v:]),
                     jnp.unwrap(jnp.angle(p[..., -nof_v:]), axis=-1), False)
    enlarged = jnp.concatenate([head, p, tail], axis=-1)

    # HIGHEST precision: a default-precision convolution may run in bf16 or
    # TF32 (~1e-3..1e-2 per-tap error), which would break the
    # reference-parity tolerance.
    conv = lambda v: jnp.convolve(v, taps.astype(v.dtype), mode="same",
                                  precision=jax.lax.Precision.HIGHEST)
    flat = enlarged.reshape(-1, enlarged.shape[-1])
    out = jax.vmap(conv)(flat).reshape(enlarged.shape)
    return out[..., nof_v : nof_v + p.shape[-1]]


@functools.partial(jax.jit, static_argnames=("cfg",))
def estimate_port_ref(grid: jax.Array, pilots: jax.Array,
                      cfg: RefEstimatorConfig) -> dict:
    """Jitted reference-semantics estimate of one rx port.

    grid: (14, nof_subc) complex64; pilots: (layers, nof_dmrs_symbols,
    nof_pilots) complex64 (per-layer, OCC included — the oracle's input).
    Returns dict(ce (layers, 14, nof_subc), freq_resp (layers,
    nof_lse_symbols, nof_subc), noise_var, rsrp, epre, snr, ta_s, cfo).
    """
    c = _constants(cfg)
    dmrs_syms = c["dmrs_syms"]
    nsym_d = len(dmrs_syms)
    layers = cfg.nof_layers
    nof_cdm = (layers + 1) // 2
    beta = jnp.float32(cfg.scaling)
    epochs = c["epochs"]
    interpolate_td = cfg.td_strategy == "interpolate"
    nof_lse = nsym_d if interpolate_td else 1

    # rx pilots per CDM group, each on its own REs: (ncdm, nsym_d, Np).
    g_d = grid[jnp.asarray([s for s in dmrs_syms]), :]  # (nsym_d, nsubc)
    rx = jnp.transpose(g_d[:, jnp.asarray(c["re_idx_g"])], (1, 0, 2))
    epre_sum = jnp.sum(jnp.abs(rx) ** 2)

    # LS match per layer.
    cdm_of = jnp.asarray([l // 2 for l in range(layers)])
    p_sym = rx[cdm_of] * jnp.conj(pilots)  # (layers, nsym_d, Np)

    # CFO from the first two DM-RS symbols: per-CDM-group angle, group
    # CFOs averaged (reference compute_hop accumulates each group's
    # estimate and divides by divide_ceil(nof_layers, 2)).
    cfo = None
    if nsym_d >= 2:
        # Oracle: angle(conj(sum vdot(p1, p0))) = angle(sum p1 * conj(p0)).
        prod_l = jnp.sum(p_sym[:, 1] * jnp.conj(p_sym[:, 0]), axis=-1)  # (layers,)
        denom = epochs[dmrs_syms[1]] - epochs[dmrs_syms[0]]
        cfo_sum = jnp.float32(0.0)
        for g0 in range(0, layers, 2):
            acc_g = sum(prod_l[l] for l in range(g0, min(g0 + 2, layers)))
            cfo_sum = cfo_sum + jnp.angle(acc_g) / (2 * np.pi) / denom
        cfo = (cfo_sum / nof_cdm).astype(jnp.float32)

    if cfo is not None and cfg.compensate_cfo:
        rot = jnp.exp(-2j * np.pi * jnp.asarray(
            [epochs[s] for s in dmrs_syms], jnp.float32) * cfo)
        p_sym = p_sym * rot[None, :, None].astype(jnp.complex64)

    if interpolate_td:
        p_lse = p_sym  # (layers, nsym_d, Np)
    else:
        p_lse = jnp.sum(p_sym, axis=1, keepdims=True)  # (layers, 1, Np)

    # CDM pair averaging.  Multi-symbol path averages every layer; the
    # single-symbol path only layers in full pairs (see oracle).
    if layers > 1:
        if nsym_d == 1:
            avg_layers = [l for l in range(layers) if (l // 2) * 2 + 1 < layers]
        else:
            avg_layers = list(range(layers))
        np_pairs = (p_lse.shape[-1] // 2) * 2
        sel = jnp.asarray([1.0 if l in avg_layers else 0.0 for l in range(layers)],
                          jnp.float32)[:, None, None]
        ev = p_lse[..., 0:np_pairs:2]
        od = p_lse[..., 1:np_pairs:2]
        avg = (ev + od) / 2.0
        new_ev = avg * sel + ev * (1.0 - sel)
        new_od = avg * sel + od * (1.0 - sel)
        p_lse = (p_lse.at[..., 0:np_pairs:2].set(new_ev)
                 .at[..., 1:np_pairs:2].set(new_od))

    total_scaling = 1.0 / beta / (nsym_d if not interpolate_td else 1.0)
    p_scaled = p_lse * total_scaling.astype(jnp.complex64)
    filtered = _fd_smooth(p_scaled, cfg, c)  # (layers, nof_lse, Np)

    rsrp_sum = jnp.sum(jnp.abs(filtered) ** 2) * beta * beta * nsym_d / nof_lse

    # Linear frequency interpolation via the precomputed exact per-layer
    # maps (each layer interpolates from its own CDM group's RE offset).
    i0, i1, wgt = (jnp.asarray(x) for x in c["interp"])  # each (layers, nof_subc)
    nof_lse_d = filtered.shape[1]
    idx0 = jnp.broadcast_to(i0[:, None, :], (layers, nof_lse_d, i0.shape[-1]))
    idx1 = jnp.broadcast_to(i1[:, None, :], (layers, nof_lse_d, i1.shape[-1]))
    f0 = jnp.take_along_axis(filtered, idx0, axis=-1)
    f1 = jnp.take_along_axis(filtered, idx1, axis=-1)
    freq_resp = f0 * (1.0 - wgt[:, None, :]) + f1 * wgt[:, None, :]
    # (layers, nof_lse, nof_subc)

    # Per-symbol CE mapping.
    sym_range = range(cfg.first_symbol, cfg.first_symbol + cfg.nof_symbols)
    ce = jnp.zeros((layers, 14, c["nof_subc"]), jnp.complex64)
    if not interpolate_td or nof_lse == 1:
        rows = freq_resp[:, 0]
        for sym in sym_range:
            ce = ce.at[:, sym].set(rows)
    else:
        ds = list(dmrs_syms)
        for sym in sym_range:
            before = [s for s in ds if s < sym]
            after = [s for s in ds if s >= sym]
            if not before:
                s0, s1 = ds[0], ds[1]
            elif not after:
                s0, s1 = ds[-2], ds[-1]
            else:
                s0, s1 = before[-1], after[0]
            wts = (sym - s0) / (s1 - s0)
            k0 = ds.index(s0)
            row = freq_resp[:, k0] + (freq_resp[:, k0 + 1] - freq_resp[:, k0]) * wts
            ce = ce.at[:, sym].set(row)

    # Noise estimation: residual against regenerated pilots.
    scaled = jnp.sum(filtered, axis=1) * (beta / nof_lse)  # (layers, Np)
    pred = scaled[:, None, :] * pilots  # (layers, nsym_d, Np)
    if cfg.compensate_cfo and cfo is not None:
        rot = jnp.exp(2j * np.pi * jnp.asarray(
            [epochs[s] for s in dmrs_syms], jnp.float32) * cfo)
        pred = pred * rot[None, :, None].astype(jnp.complex64)
    noise_sum = jnp.float32(0.0)
    for g0 in range(0, layers, 2):
        group = list(range(g0, min(g0 + 2, layers)))
        cdm = g0 // 2
        pred_g = sum(pred[l] for l in group)
        resid = rx[cdm] - pred_g
        energy = jnp.sum(jnp.abs(resid) ** 2)
        noise_sum = noise_sum + jnp.where(jnp.isfinite(energy) & (energy > 0),
                                          energy, 0.0)

    # Time alignment: zero-padded IDFT correlation peak.
    dft_size = c["dft_size"]
    buf = jnp.zeros((layers * nof_lse, dft_size), jnp.complex64)
    flat_f = filtered.reshape(layers * nof_lse, -1)
    buf = buf.at[:, jnp.asarray(c["ta_positions"])].set(flat_f)
    t = jnp.fft.ifft(buf, axis=-1) * dft_size
    corr = jnp.sum(jnp.abs(t) ** 2, axis=0)
    mts = c["max_ta_samples"]
    delay_idx = jnp.argmax(corr[:mts])
    delay_max = corr[delay_idx]
    adv = corr[-mts:]
    adv_idx = jnp.argmax(adv)
    adv_max = adv[adv_idx]
    idx = jnp.where(delay_max >= adv_max, delay_idx,
                    -(mts - adv_idx)).astype(jnp.int32)
    frac = jnp.float32(0.0)
    if dft_size != _oracle._MAX_DFT:
        nof_taps = 5 if mts > 2 else 3
        offs = jnp.arange(nof_taps) - nof_taps // 2
        peak = corr[(idx + offs + dft_size) % dft_size]
        if nof_taps == 5:
            num_w = jnp.asarray([-0.4, -0.2, 0.0, 0.2, 0.4], jnp.float32)
            den_w = jnp.asarray([0.571429, -0.285714, -0.571429, -0.285714,
                                 0.571429], jnp.float32)
            corr_f = 1.0
        else:
            num_w = jnp.asarray([-0.5, 0.0, 0.5], jnp.float32)
            den_w = jnp.asarray([0.5, -1.0, 0.5], jnp.float32)
            corr_f = 0.5
        num = jnp.dot(num_w, peak, precision=jax.lax.Precision.HIGHEST)
        den = jnp.dot(den_w, peak, precision=jax.lax.Precision.HIGHEST)
        res = jnp.where(den != 0, -corr_f * num / jnp.where(den != 0, den, 1.0),
                        jnp.nan)
        frac = jnp.where(jnp.isfinite(res) & (jnp.abs(res) <= 1.0), res, 0.0)
    ta_s = (idx.astype(jnp.float32) + frac) / np.float32(c["fs"])

    # Final statistics.
    nof_pilots = len(c["re_idx"])
    nof_dmrs_pilots = nof_pilots * nsym_d
    rsrp = rsrp_sum / (nof_dmrs_pilots * layers)
    epre = epre_sum / nof_dmrs_pilots
    noise_var = noise_sum / (nof_dmrs_pilots * nof_cdm - 1)
    noise_var = jnp.maximum(noise_var, rsrp / np.float32(10 ** (MAX_SINR_DB / 10)))
    datarp = rsrp * layers / (beta * beta)
    snr = jnp.where(jnp.isfinite(noise_var) & (noise_var > 0),
                    datarp / noise_var, 0.0)

    # Re-apply CFO rotation to the channel estimates.
    if cfg.compensate_cfo and cfo is not None:
        rot = jnp.exp(2j * np.pi * jnp.asarray(epochs, jnp.float32) * cfo)
        ce = ce * rot[None, :, None].astype(jnp.complex64)

    return {
        "ce": ce.astype(jnp.complex64),
        "freq_resp": freq_resp.astype(jnp.complex64),
        "noise_var": noise_var.astype(jnp.float32),
        "rsrp": rsrp.astype(jnp.float32),
        "epre": epre.astype(jnp.float32),
        "snr": snr.astype(jnp.float32),
        "ta_s": ta_s,
        "cfo": (cfo if cfo is not None else jnp.float32(0.0)),
    }
