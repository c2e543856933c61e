"""Modulation mapping (TS 38.211 §5.1): BPSK .. 256QAM.

Counterpart of the reference's modulation_mapper_lut/avx512 impls
(lib/phy/upper/channel_modulation/modulation_mapper_lut_impl.cpp) — here
the symbols come straight from the nested Gray PAM recursion as
elementwise vector math (no LUT gather on the hot path; the LUT stays for
oracles/EVM), and batching over symbols is free.
"""

from __future__ import annotations

import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np


class Modulation(enum.IntEnum):
    """Modulation schemes, value = bits per symbol Qm (pi/2-BPSK = 0 sentinel)."""

    PI_2_BPSK = 0
    BPSK = 1
    QPSK = 2
    QAM16 = 4
    QAM64 = 6
    QAM256 = 8


def bits_per_symbol(mod: Modulation) -> int:
    return 1 if mod == Modulation.PI_2_BPSK else int(mod)


def _pam(bits: np.ndarray) -> np.ndarray:
    """Per-axis PAM amplitude from sign bit b0 and magnitude bits (TS 38.211 §5.1.4+).

    bits: (n_sym, m) with bits[:, 0] the sign bit, following the nested Gray
    construction  a = (1-2b0) * (2^{m-1} - sum ...), built recursively.
    """
    n, m = bits.shape
    amp = np.ones(n)
    for k in range(m - 1, 0, -1):
        amp = 2 ** (m - k) - (1 - 2 * bits[:, k]) * amp
    return (1 - 2 * bits[:, 0]) * amp


@functools.lru_cache(maxsize=None)
def constellation(mod: Modulation) -> np.ndarray:
    """(2^Qm,) complex64 LUT, index = bits MSB-first as written to the symbol."""
    qm = bits_per_symbol(mod)
    n = 1 << qm
    idx = np.arange(n)
    bits = ((idx[:, None] >> (qm - 1 - np.arange(qm))) & 1).astype(np.int64)
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK):
        b = bits[:, 0]
        pts = ((1 - 2 * b) + 1j * (1 - 2 * b)) / np.sqrt(2)
    elif mod == Modulation.QPSK:
        pts = ((1 - 2 * bits[:, 0]) + 1j * (1 - 2 * bits[:, 1])) / np.sqrt(2)
    else:
        # I axis uses even-position bits, Q axis odd-position bits.
        m = qm // 2
        i_amp = _pam(bits[:, 0::2])
        q_amp = _pam(bits[:, 1::2])
        scale = {4: 10.0, 6: 42.0, 8: 170.0}[qm]
        pts = (i_amp + 1j * q_amp) / np.sqrt(scale)
    return pts.astype(np.complex64)


def pam_levels(mod: Modulation) -> np.ndarray:
    """Sorted unique per-axis amplitudes with their axis bit labels.

    Returns (levels (2^m,), labels (2^m, m)) for one axis.
    """
    qm = bits_per_symbol(mod)
    m = max(qm // 2, 1)
    n = 1 << m
    idx = np.arange(n)
    bits = ((idx[:, None] >> (m - 1 - np.arange(m))) & 1).astype(np.int64)
    if qm <= 2:
        amp = (1 - 2 * bits[:, 0]).astype(np.float64)
        scale = np.sqrt(2.0)
    else:
        amp = _pam(bits).astype(np.float64)
        scale = np.sqrt({4: 10.0, 6: 42.0, 8: 170.0}[qm])
    levels = amp / scale
    order = np.argsort(levels)
    return levels[order], bits[order]


@functools.partial(jax.jit, static_argnames=("mod",))
def map_bits(bits: jax.Array, mod: Modulation) -> jax.Array:
    """(..., E) bits -> (..., E/Qm) complex64 symbols.

    For PI_2_BPSK, symbol i gets an extra exp(j*pi/2*(i mod 2)) rotation
    (TS 38.211 §5.1.1).
    """
    qm = bits_per_symbol(mod)
    e = bits.shape[-1]
    assert e % qm == 0
    # Symbols arithmetically from the nested Gray PAM recursion (TS
    # 38.211 §5.1.4+): pure elementwise f32 math — no million-row gather
    # through a 2^Qm LUT; the closed form fuses into one elementwise pass).
    group = bits.astype(jnp.float32).reshape(bits.shape[:-1] + (e // qm, qm))
    if qm == 1:
        b = group[..., 0]
        r = (1.0 - 2.0 * b) * np.float32(1.0 / np.sqrt(2))
        syms = jax.lax.complex(r, r)
        if mod == Modulation.PI_2_BPSK:
            n = syms.shape[-1]
            rot = jnp.where(jnp.arange(n) % 2 == 1, 1j, 1.0).astype(jnp.complex64)
            syms = syms * rot
        return syms
    if qm == 2:
        s2 = np.float32(1.0 / np.sqrt(2))
        return jax.lax.complex((1.0 - 2.0 * group[..., 0]) * s2,
                               (1.0 - 2.0 * group[..., 1]) * s2)
    m = qm // 2
    scale = {4: 10.0, 6: 42.0, 8: 170.0}[qm]

    def pam(axis_bits):
        # axis_bits: (..., m) with [:, 0] the sign bit.
        amp = jnp.ones(axis_bits.shape[:-1], jnp.float32)
        for k in range(m - 1, 0, -1):
            amp = 2.0 ** (m - k) - (1.0 - 2.0 * axis_bits[..., k]) * amp
        return (1.0 - 2.0 * axis_bits[..., 0]) * amp

    i_amp = pam(group[..., 0::2])
    q_amp = pam(group[..., 1::2])
    s = np.float32(1.0 / np.sqrt(scale))
    syms = jax.lax.complex(i_amp * s, q_amp * s)
    if mod == Modulation.PI_2_BPSK:
        n = syms.shape[-1]
        rot = jnp.where(jnp.arange(n) % 2 == 1, 1j, 1.0).astype(jnp.complex64)
        syms = syms * rot
    return syms
