"""OFDM modulation / demodulation (TS 38.211 §5.3-5.4).

Counterpart of the reference's ofdm_modulator/ofdm_demodulator
(lib/phy/lower/modulation/ofdm_modulator_impl.cpp:58, ofdm_demodulator_impl.cpp:96)
and its FFTW dft_processor — as one jitted program per static (scs,
dft_size, nof_rb, cp, f_center) carrier configuration that processes a
whole slot of symbols as a batch.  The (I)DFT is jnp.fft (cuFFT on the GPU);
the half-spectrum grid placement, per-symbol phase-compensation
coefficients (TS 38.211 §5.4) and gather-based cyclic-prefix handling are
all static tensor ops.

Conventions:
  * grid axes (..., nof_symbols, nof_subcarriers); subcarrier k sits at
    frequency (k - nsc/2) * scs relative to the carrier center;
  * modulate: x_l = scale * sum_k S_k e^{j2pi k n/N}  (i.e. N*ifft), then
    phase-compensated by exp(-j*2pi*f_center*t_l) with t_l the start time
    of symbol l's useful part within its subframe; demodulate applies the
    conjugate (reference: phase_compensation_lut.h:31).
  * default scale 1/sqrt(N) makes mod/demod a unitary pair.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ran.constants import (
    NRE,
    CyclicPrefix,
    SubcarrierSpacing,
    cp_lengths,
    nof_symbols_per_slot,
    sampling_rate_hz,
)


def _fft(x: jax.Array) -> jax.Array:
    """Forward DFT over the last axis (fft semantics)."""
    return jnp.fft.fft(x, axis=-1).astype(jnp.complex64)


def _ifft(x: jax.Array) -> jax.Array:
    """Normalized inverse DFT over the last axis (ifft semantics)."""
    return jnp.fft.ifft(x, axis=-1).astype(jnp.complex64)


@functools.lru_cache(maxsize=None)
def _slot_geometry(scs: SubcarrierSpacing, dft_size: int, cp: CyclicPrefix, slot_in_subframe: int):
    """Per-symbol (cp_len, t_start_useful_seconds) for one slot."""
    nsym = nof_symbols_per_slot(cp)
    all_cps = cp_lengths(scs, dft_size, cp)
    fs = sampling_rate_hz(scs, dft_size)
    # Start-of-subframe-relative sample offsets.
    starts = np.cumsum([0] + [c + dft_size for c in all_cps])[:-1]
    sel = slice(slot_in_subframe * nsym, (slot_in_subframe + 1) * nsym)
    cps = all_cps[sel]
    t_useful = [(starts[i] + all_cps[i]) / fs for i in range(*sel.indices(len(all_cps)))]
    return tuple(cps), tuple(t_useful)


@functools.lru_cache(maxsize=None)
def _phase_comp(
    scs: SubcarrierSpacing,
    dft_size: int,
    cp: CyclicPrefix,
    slot_in_subframe: int,
    f_center_hz: float,
) -> np.ndarray:
    """(nsym,) complex64 TX phase-compensation coefficients exp(-j2pi*fc*t_l).

    Computed in float64 with the 2*pi*fc*t product reduced mod 1 cycle
    before the complex exponential (fc ~ GHz needs the headroom).
    """
    _, t_useful = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    cycles = np.array([f_center_hz * t for t in t_useful], dtype=np.float64)
    frac = cycles - np.round(cycles)
    return np.exp(-2j * np.pi * frac).astype(np.complex64)


def slot_nof_samples(scs: SubcarrierSpacing, dft_size: int, cp: CyclicPrefix, slot_in_subframe: int) -> int:
    cps, _ = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    return sum(cps) + len(cps) * dft_size


@functools.partial(
    jax.jit,
    static_argnames=("scs", "dft_size", "cp", "slot_in_subframe", "f_center_hz", "scale"),
)
def modulate_slot(
    grid: jax.Array,
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30,
    dft_size: int = 1024,
    cp: CyclicPrefix = CyclicPrefix.NORMAL,
    slot_in_subframe: int = 0,
    f_center_hz: float = 0.0,
    scale: float | None = None,
) -> jax.Array:
    """Grid (..., nsym, nsc) -> baseband samples (..., slot_nof_samples).

    nsc (= nof_rb * 12) must be <= dft_size.
    """
    nsym, nsc = grid.shape[-2], grid.shape[-1]
    assert nsym == nof_symbols_per_slot(cp)
    assert nsc <= dft_size and nsc % 2 == 0
    if scale is None:
        scale = 1.0 / np.sqrt(dft_size)
    half = nsc // 2
    batch = grid.shape[:-2]

    # Half-spectrum placement: positive freqs -> low bins, negative -> top.
    spec = jnp.zeros(batch + (nsym, dft_size), dtype=jnp.complex64)
    spec = spec.at[..., :half].set(grid[..., half:])
    spec = spec.at[..., dft_size - half :].set(grid[..., :half])

    x = _ifft(spec).astype(jnp.complex64) * (dft_size * scale)

    cps, _ = _slot_geometry(scs, dft_size, cp, slot_in_subframe)
    phase = _phase_comp(scs, dft_size, cp, slot_in_subframe, f_center_hz)
    x = x * jnp.asarray(phase)[:, None]

    # CP prepend via ONE precomputed gather over the flattened symbols
    # (28 concatenated slices copy the waveform twice; the gather is one
    # fused read): output sample -> (symbol, intra-symbol index).
    out_idx = []
    for l in range(nsym):
        base = l * dft_size
        out_idx.append(base + np.arange(dft_size - cps[l], dft_size))  # CP
        out_idx.append(base + np.arange(dft_size))
    oidx = jnp.asarray(np.concatenate(out_idx).astype(np.int32))
    flat = x.reshape(x.shape[:-2] + (nsym * dft_size,))
    return flat[..., oidx]


@functools.partial(
    jax.jit,
    static_argnames=(
        "nof_rb", "scs", "dft_size", "cp", "slot_in_subframe", "f_center_hz", "scale",
        "window_offset", "window_offset_samples",
    ),
)
def demodulate_slot(
    samples: jax.Array,
    nof_rb: int,
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30,
    dft_size: int = 1024,
    cp: CyclicPrefix = CyclicPrefix.NORMAL,
    slot_in_subframe: int = 0,
    f_center_hz: float = 0.0,
    scale: float | None = None,
    window_offset: float = 0.0,
    window_offset_samples: int | None = None,
) -> jax.Array:
    """Baseband samples (..., slot_nof_samples) -> grid (..., nsym, nsc).

    window_offset in [0, 1): advance the DFT window INTO the cyclic prefix
    by that fraction of the CP (the reference's intra-CP window,
    ofdm_demodulator_impl.cpp:63-77), compensated per-bin with a linear
    phase ramp.  Improves robustness to negative timing errors / ISI.
    window_offset_samples: alternatively, a FIXED advance in samples for
    every symbol — the reference's nof_samples_window_offset convention
    (must be < 144*dft_size/2048, i.e. within the shortest CP).
    """
    nsym = nof_symbols_per_slot(cp)
    nsc = nof_rb * NRE
    if scale is None:
        scale = 1.0 / np.sqrt(dft_size)
    cps, _ = _slot_geometry(scs, dft_size, cp, slot_in_subframe)

    # Extract each symbol's useful part with ONE precomputed gather (a
    # python loop of 14 slices + stack copies the waveform twice; the
    # gather is a single fused read); optionally start the window `adv_l`
    # samples early (inside the CP).
    offs = 0
    advs = []
    idx_rows = []
    for l in range(nsym):
        if window_offset_samples is not None:
            adv = int(window_offset_samples)
        else:
            adv = int(window_offset * cps[l])
        advs.append(adv)
        offs += cps[l]
        idx_rows.append(np.arange(offs - adv, offs - adv + dft_size))
        offs += dft_size
    gidx = jnp.asarray(np.stack(idx_rows).astype(np.int32))  # (nsym, dft)
    x = samples[..., gidx]  # (..., nsym, dft)

    phase = _phase_comp(scs, dft_size, cp, slot_in_subframe, f_center_hz)
    x = x * jnp.conj(jnp.asarray(phase))[:, None]

    spec = _fft(x).astype(jnp.complex64) / (dft_size * scale)
    half = nsc // 2
    grid = jnp.concatenate([spec[..., dft_size - half :], spec[..., :half]], axis=-1)
    if window_offset or window_offset_samples:
        # A window advanced by `adv` samples rotates bin k by
        # exp(+j*2*pi*k*adv/N) (k = signed subcarrier index); undo it.
        k = np.arange(nsc) - half
        corr = np.stack(
            [np.exp(2j * np.pi * k * adv / dft_size) for adv in advs]
        ).astype(np.complex64)  # (nsym, nsc)
        grid = grid * jnp.asarray(corr)
    return grid
