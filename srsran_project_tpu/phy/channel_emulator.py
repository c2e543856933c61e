"""TDL fading channel emulator for BLER testing.

Counterpart of the reference's pxsch_bler_test_channel_emulator
(tests/integrationtests/phy/upper/channel_processors/
pxsch_bler_test_channel_emulator.cpp:42-121): TDLA/TDLB/TDLC tap profiles
(TS 38.104 annex G delay/power tables), Rayleigh per-tap fading, optional
CFO, AWGN at a configured SINR.  Operates directly on resource grids in the
frequency domain: H(r,t,k) = sum_taps g * exp(-j2pi k scs tau).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ran.constants import SubcarrierSpacing, scs_khz

# Full f32 products for the channel: a TF32 product would add a ~1e-3
# relative error floor to the received signal, above the high-SNR points.
_HIGHEST = jax.lax.Precision.HIGHEST

# (delay ns, power dB) tap tables.
PROFILES = {
    "single": ((0, 0.0),),
    "tdla": (
        (0, -15.5), (10, 0.0), (15, -5.1), (20, -5.1), (25, -9.6), (50, -8.2),
        (65, -13.1), (75, -11.5), (105, -11.0), (135, -16.2), (150, -16.6), (290, -26.2),
    ),
    "tdlb": (
        (0, 0.0), (10, -2.2), (20, -0.6), (30, -0.6), (35, -0.3), (45, -1.2),
        (55, -5.9), (120, -2.2), (170, -0.8), (245, -6.3), (330, -7.5), (480, -7.1),
    ),
    "tdlc": (
        (0, -6.9), (65, 0.0), (70, -7.7), (190, -2.5), (195, -2.4), (200, -9.9),
        (240, -8.0), (325, -6.6), (520, -7.1), (1045, -13.0), (1510, -14.2), (2595, -16.0),
    ),
}


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    profile: str = "tdla"
    sinr_db: float = 20.0
    nof_tx_ports: int = 1
    nof_rx_ports: int = 1
    nof_sc: int = 624
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30
    cfo_hz: float = 0.0
    # Noise reference convention: "post_fading" sets the noise so every
    # slot sees exactly sinr_db against its own faded signal power (no
    # slow-fading outage); "fixed" pins the noise variance to the NOMINAL
    # unit signal like the reference's pxsch_bler_test channel emulator
    # (fading dips then cause outages — required for BLER parity).
    noise_convention: str = "post_fading"
    # Maximum Doppler shift in Hz.  0 = block fading (one i.i.d. channel
    # drop per slot, the reference emulator's model); > 0 = Jakes-spectrum
    # time-selective fading via sum-of-sinusoids, continuous across symbols
    # and slots (exceeds the reference; stresses CFO/time-interp paths).
    doppler_hz: float = 0.0
    nof_sinusoids: int = 8


@functools.lru_cache(maxsize=None)
def _tap_params(profile: str, nof_sc: int, scs: SubcarrierSpacing):
    taps = PROFILES[profile]
    delays = np.asarray([t[0] for t in taps], np.float64) * 1e-9
    powers_db = np.asarray([t[1] for t in taps], np.float64)
    p = 10.0 ** (powers_db / 10.0)
    p /= p.sum()  # unit total power
    f = np.arange(nof_sc, dtype=np.float64) * scs_khz(scs) * 1e3
    steer = np.exp(-2j * np.pi * f[None, :] * delays[:, None])  # (T, nsc)
    return np.sqrt(p).astype(np.float32), steer.astype(np.complex64)


@functools.partial(jax.jit, static_argnames=("cfg",))
def draw_channel(key: jax.Array, cfg: ChannelConfig) -> jax.Array:
    """Random frequency response (nrx, ntx, nsc).

    Unit average power per (rx, tx) pair — except under the "fixed"
    (reference-parity) noise convention, where the reference emulator's
    normalization applies: norm = 1/sqrt(nof_rx_ports * taps_power)
    (pxsch_bler_test_channel_emulator.cpp:141), so that with layers ==
    rx ports the total received power per RE stays ~unit and the fixed
    noise floor realizes the configured SINR."""
    amp, steer = _tap_params(cfg.profile, cfg.nof_sc, cfg.scs)
    ntap = len(amp)
    g = jax.random.normal(
        key, (cfg.nof_rx_ports, cfg.nof_tx_ports, ntap, 2), dtype=jnp.float32
    )
    g = (g[..., 0] + 1j * g[..., 1]) / np.sqrt(2) * jnp.asarray(amp)
    if cfg.noise_convention == "fixed":
        g = g / np.sqrt(float(cfg.nof_rx_ports))
    return jnp.einsum("rtn,nk->rtk", g.astype(jnp.complex64), jnp.asarray(steer), precision=_HIGHEST)


@functools.lru_cache(maxsize=None)
def _symbol_times_s(scs: SubcarrierSpacing, nof_symbols: int = 14):
    """Per-symbol start times in seconds (CP-cumulative, like the reference
    emulator's CFO coefficients, pxsch_bler_test_channel_emulator.cpp:165-176)."""
    mu = int(scs)
    sym_s = 1e-3 / (14 * (1 << mu)) * 14 / 14  # useful symbol duration
    sym_s = 1.0 / (scs_khz(scs) * 1e3)
    t = np.zeros(nof_symbols)
    acc = 0.0
    for l in range(nof_symbols):
        cp_frac = 144.0 / 2048.0 + (16.0 / 2048.0 * (1 << mu) if l % (7 << mu) == 0 else 0.0)
        acc += cp_frac * sym_s
        t[l] = acc
        acc += sym_s
    return t


@functools.partial(jax.jit, static_argnames=("cfg", "slot_index"))
def draw_channel_doppler(key: jax.Array, cfg: ChannelConfig, slot_index: int = 0) -> jax.Array:
    """Time-selective frequency response (nrx, ntx, nsym, nsc).

    Jakes sum-of-sinusoids per tap: g(t) = 1/sqrt(N) sum_n exp(j(2 pi f_d
    cos(theta_n) t + phi_n)) with (theta, phi) drawn from `key` — the same
    key yields a continuous fading trajectory across slots via slot_index.
    """
    amp, steer = _tap_params(cfg.profile, cfg.nof_sc, cfg.scs)
    ntap = len(amp)
    n_sin = cfg.nof_sinusoids
    k1, k2 = jax.random.split(key)
    shape = (cfg.nof_rx_ports, cfg.nof_tx_ports, ntap, n_sin)
    theta = jax.random.uniform(k1, shape, jnp.float32, 0.0, 2 * np.pi)
    phi = jax.random.uniform(k2, shape, jnp.float32, 0.0, 2 * np.pi)
    slot_s = 1e-3 / (1 << int(cfg.scs))
    t = jnp.asarray(_symbol_times_s(cfg.scs) + slot_index * slot_s, jnp.float32)  # (nsym,)
    w = 2 * np.pi * cfg.doppler_hz * jnp.cos(theta)  # (..., ntap, N)
    ph = w[..., None, :] * t[:, None] + phi[..., None, :]  # (..., ntap, nsym, N)
    g = jnp.exp(1j * ph).sum(axis=-1) / np.sqrt(n_sin)  # (..., ntap, nsym)
    g = g * jnp.asarray(amp)[:, None]
    return jnp.einsum("rtns,nk->rtsk", g.astype(jnp.complex64), jnp.asarray(steer), precision=_HIGHEST)


@functools.partial(jax.jit, static_argnames=("cfg", "slot_index"))
def apply_channel(grid: jax.Array, key: jax.Array, cfg: ChannelConfig, slot_index: int = 0):
    """(ntx, nsym, nsc) grid -> (nrx, nsym, nsc) faded + AWGN grid.

    Returns (rx_grid, h, noise_var scalar); h is (nrx, ntx, nsc) for block
    fading or (nrx, ntx, nsym, nsc) with Doppler enabled."""
    kh, kn = jax.random.split(key)
    if cfg.doppler_hz:
        h = draw_channel_doppler(kh, cfg, slot_index)
        rx = jnp.einsum("rtsk,tsk->rsk", h, grid.astype(jnp.complex64), precision=_HIGHEST)
    else:
        h = draw_channel(kh, cfg)
        rx = jnp.einsum("rtk,tsk->rsk", h, grid.astype(jnp.complex64), precision=_HIGHEST)
    if cfg.cfo_hz:
        # Exact per-symbol CFO phase at CP-cumulative symbol start times.
        t = jnp.asarray(_symbol_times_s(cfg.scs, grid.shape[-2]), jnp.float32)
        phase = jnp.exp(2j * np.pi * cfg.cfo_hz * t)
        rx = rx * phase[None, :, None].astype(jnp.complex64)
    # Signal power per RE is E|grid|^2 * sum tap power ~ grid power; compute
    # noise from the configured SINR against the actual mean signal power,
    # or against the nominal unit signal (reference emulator convention).
    if cfg.noise_convention == "fixed":
        sig_pow = jnp.float32(1.0)
    else:
        sig_pow = jnp.mean(jnp.abs(rx) ** 2)
    nvar = sig_pow / (10.0 ** (cfg.sinr_db / 10.0))
    noise = jax.random.normal(kn, rx.shape + (2,), dtype=jnp.float32)
    noise = (noise[..., 0] + 1j * noise[..., 1]) * jnp.sqrt(nvar / 2)
    return rx + noise.astype(jnp.complex64), h, nvar


def apply_channel_time(samples, key, cfg: ChannelConfig, srate_hz: float):
    """Time-domain TDL channel for BASEBAND sample streams (the RU/lower-
    PHY path): per-tap Rayleigh gains at the TS 38.104 delay profile are
    applied as a sparse FIR (delays rounded to the sample grid) per
    (rx, tx) pair, then AWGN at the configured SINR.

    samples: (nof_tx_ports, nsamples) complex64 -> (nof_rx_ports, nsamples).
    The frequency-domain `apply_channel` is the per-slot-grid equivalent;
    this variant exercises true multipath through the OFDM CP.
    """
    samples = jnp.asarray(samples, jnp.complex64)
    taps = PROFILES[cfg.profile]
    delays_s = np.asarray([t[0] for t in taps], np.float64) * 1e-9
    powers_db = np.asarray([t[1] for t in taps], np.float64)
    p = 10.0 ** (powers_db / 10.0)
    p = p / p.sum()
    delay_samples = np.round(delays_s * srate_hz).astype(np.int32)

    kg, kn = jax.random.split(key)
    g = (jax.random.normal(kg, (cfg.nof_rx_ports, cfg.nof_tx_ports, len(taps), 2))
         @ jnp.asarray([1.0, 1j], jnp.complex64)) * jnp.asarray(
        np.sqrt(p / 2.0), jnp.complex64)

    n = samples.shape[-1]
    out = jnp.zeros((cfg.nof_rx_ports, n), jnp.complex64)
    for ti, d in enumerate(delay_samples):
        shifted = jnp.pad(samples, ((0, 0), (int(d), 0)))[:, :n]
        out = out + jnp.einsum("rt,ts->rs", g[:, :, ti], shifted, precision=_HIGHEST)
    sig_pow = jnp.mean(jnp.abs(out) ** 2)
    nstd = jnp.sqrt(sig_pow * 10.0 ** (-cfg.sinr_db / 10.0) / 2.0)
    noise = (jax.random.normal(kn, out.shape + (2,))
             @ jnp.asarray([1.0, 1j], jnp.complex64)) * nstd
    return (out + noise).astype(jnp.complex64)
