"""Soft demapping: interval-based piecewise-linear max-log LLRs.

Counterpart of the reference's demodulation_mapper_qam{16,64,256}
(lib/phy/upper/channel_modulation/demodulation_mapper_intervals.h): for
Gray-mapped QAM the exact max-log LLR of each bit is piecewise linear in the
per-axis observation, so each bit has a small table of (slope, intercept)
pairs indexed by clamp(floor(y/width) + n/2).  Here the tables are derived
*numerically* from the exact max-log expression at import time (instead of
hand-coded constants), which keeps them correct for every constellation by
construction.  On device a demap is: gather two small LUT rows, one fused
multiply-add, scale by 1/noise-variance.

LLR sign convention: positive = bit 0 (matches the reference's
log_likelihood_ratio).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .mapper import Modulation, bits_per_symbol, pam_levels

LLR_MAX = 120


def _maxlog_llr(y: np.ndarray, levels: np.ndarray, labels: np.ndarray, bit: int) -> np.ndarray:
    """Exact per-axis max-log LLR (noise variance 1): min over hypotheses."""
    d2 = (y[:, None] - levels[None, :]) ** 2
    b = labels[:, bit]
    m0 = d2[:, b == 0].min(axis=1)
    m1 = d2[:, b == 1].min(axis=1)
    return m1 - m0


@functools.lru_cache(maxsize=None)
def _interval_tables(mod: Modulation):
    """Piecewise-linear tables per axis bit.

    Returns (width, nof_intervals, slopes (m, NI), intercepts (m, NI)).
    Interval k covers y in [ (k - NI/2)*w, (k - NI/2 + 1)*w ); outer
    intervals extend to +-inf (the LLR is linear outside the constellation).
    """
    levels, labels = pam_levels(mod)
    m = labels.shape[1]
    # Breakpoints of the max-log LLR lie on multiples of half the level
    # spacing; interval width = level spacing / 2 covers all of them.
    if len(levels) == 1:
        raise ValueError("BPSK handled separately")
    spacing = levels[1] - levels[0]
    width = spacing / 2
    span = levels[-1] + spacing  # cover a margin beyond the outer level
    ni = int(np.ceil(2 * span / width / 2)) * 2
    slopes = np.zeros((m, ni), dtype=np.float32)
    intercepts = np.zeros((m, ni), dtype=np.float32)
    for k in range(ni):
        lo = (k - ni // 2) * width
        # Sample two interior points of the interval to fit the line.
        y = np.array([lo + width / 4, lo + 3 * width / 4])
        for b in range(m):
            v = _maxlog_llr(y, levels, labels, b)
            sl = (v[1] - v[0]) / (width / 2)
            ic = v[0] - sl * y[0]
            slopes[b, k] = sl
            intercepts[b, k] = ic
    return float(width), ni, slopes, intercepts


def _axis_llrs_closed(y: jax.Array, levels: np.ndarray, labels: np.ndarray) -> jax.Array:
    """Exact per-axis max-log LLRs by direct distance minimization.

    Pure unrolled elementwise math (2^m subtract/square chains + min
    trees): no LUT gather through the (m, NI) interval tables, at ~5x
    the flops of the table form; elementwise chains fuse into one
    kernel, and the code has no dynamic indexing.

    Returns (m, ...) LLRs, positive = bit 0 — identical (up to float
    rounding) to the interval-table evaluation, which is itself a
    piecewise-linear encoding of this same exact max-log expression.
    """
    m = labels.shape[1]
    d2 = [(y - np.float32(l)) ** 2 for l in levels]
    outs = []
    for b in range(m):
        m0 = m1 = None
        for l, d in enumerate(d2):
            if labels[l, b]:
                m1 = d if m1 is None else jnp.minimum(m1, d)
            else:
                m0 = d if m0 is None else jnp.minimum(m0, d)
        outs.append(m1 - m0)
    return jnp.stack(outs)


@functools.partial(jax.jit, static_argnames=("mod",))
def demap_soft(symbols: jax.Array, noise_var: jax.Array, mod: Modulation) -> jax.Array:
    """(..., S) complex symbols + (..., S) noise variance -> (..., S*Qm) float LLRs.

    Output order matches the mapper's bit order (I/Q interleaved for QAM).
    """
    qm = bits_per_symbol(mod)
    shape = symbols.shape
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK):
        if mod == Modulation.PI_2_BPSK:
            n = shape[-1]
            derot = jnp.where(jnp.arange(n) % 2 == 1, -1j, 1.0).astype(jnp.complex64)
            symbols = symbols * derot
        # d = (b' + j b')/sqrt(2): project on (1+j)/sqrt(2).
        proj = (symbols.real + symbols.imag) / np.sqrt(2)
        llr = 4.0 * proj / noise_var
        return llr.reshape(shape[:-1] + (shape[-1] * 1,))
    if mod == Modulation.QPSK:
        llr_i = 2.0 * np.sqrt(2.0) * symbols.real / noise_var
        llr_q = 2.0 * np.sqrt(2.0) * symbols.imag / noise_var
        return jnp.stack([llr_i, llr_q], axis=-1).reshape(shape[:-1] + (shape[-1] * 2,))

    m = qm // 2
    levels, labels = pam_levels(mod)

    def axis_llrs(y):
        return _axis_llrs_closed(y, levels, labels)

    inv_nv = 1.0 / noise_var
    li = axis_llrs(symbols.real) * inv_nv  # (m, ..., S): bits 0,2,4,..
    lq = axis_llrs(symbols.imag) * inv_nv  # (m, ..., S): bits 1,3,5,..
    # Interleave axis bits: out[..., s*qm + 2t] = li[t], out[..., s*qm + 2t+1] = lq[t]
    # (noise division happens on the (m, ..., S) layout — the old
    # jnp.repeat(noise_var, qm) materialized a 40 MB broadcast per slot).
    both = jnp.stack([li, lq], axis=-1)  # (m, ..., S, 2)
    both = jnp.moveaxis(both, 0, -2)  # (..., S, m, 2)
    return both.reshape(shape[:-1] + (shape[-1] * qm,))


def quantize_llr(llrs: jax.Array, range_limit: float = 20.0) -> jax.Array:
    """Mid-tread uniform quantization of float LLRs to int8 in [-LLR_MAX, LLR_MAX]
    (reference: log_likelihood_ratio.h:131-140)."""
    scaled = llrs * (LLR_MAX / range_limit)
    return jnp.clip(jnp.round(scaled), -LLR_MAX, LLR_MAX).astype(jnp.int8)
