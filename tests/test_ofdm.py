"""OFDM modulator/demodulator round trips and structure checks."""

import numpy as np
import pytest

from srsran_project_tpu.ops import ofdm
from srsran_project_tpu.ran.constants import CyclicPrefix, SubcarrierSpacing


def _random_grid(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("slot", [0, 1])
def test_mod_demod_roundtrip(slot):
    rng = np.random.default_rng(slot)
    nof_rb, dft = 52, 1024  # 20 MHz-ish at 30 kHz SCS
    grid = _random_grid(rng, (2, 14, nof_rb * 12))
    x = np.asarray(
        ofdm.modulate_slot(
            grid, SubcarrierSpacing.KHZ30, dft, CyclicPrefix.NORMAL, slot, f_center_hz=3.5e9
        )
    )
    assert x.shape[-1] == ofdm.slot_nof_samples(SubcarrierSpacing.KHZ30, dft, CyclicPrefix.NORMAL, slot)
    back = np.asarray(
        ofdm.demodulate_slot(
            x, nof_rb, SubcarrierSpacing.KHZ30, dft, CyclicPrefix.NORMAL, slot, f_center_hz=3.5e9
        )
    )
    np.testing.assert_allclose(back, grid, atol=2e-3)


def test_cyclic_prefix_is_cyclic():
    rng = np.random.default_rng(2)
    nof_rb, dft = 24, 512
    grid = _random_grid(rng, (14, nof_rb * 12))
    x = np.asarray(ofdm.modulate_slot(grid, SubcarrierSpacing.KHZ15, dft, CyclicPrefix.NORMAL, 0))
    from srsran_project_tpu.ran.constants import cp_lengths

    cps = cp_lengths(SubcarrierSpacing.KHZ15, dft)[:14]
    off = 0
    for l in range(14):
        cp_part = x[off : off + cps[l]]
        body_tail = x[off + cps[l] + dft - cps[l] : off + cps[l] + dft]
        np.testing.assert_allclose(cp_part, body_tail, atol=1e-6)
        off += cps[l] + dft


def test_single_tone_lands_on_expected_bin():
    # A lone subcarrier k maps to frequency (k - nsc/2)*scs.
    nof_rb, dft = 4, 128
    nsc = nof_rb * 12
    grid = np.zeros((14, nsc), dtype=np.complex64)
    k = nsc // 2 + 3  # positive frequency bin +3
    grid[0, k] = 1.0
    x = np.asarray(ofdm.modulate_slot(grid, SubcarrierSpacing.KHZ15, dft, CyclicPrefix.NORMAL, 0))
    from srsran_project_tpu.ran.constants import cp_lengths

    cp0 = cp_lengths(SubcarrierSpacing.KHZ15, dft)[0]
    body = x[cp0 : cp0 + dft]
    spec = np.fft.fft(body)
    peak = np.argmax(np.abs(spec))
    assert peak == 3


def test_extended_cp():
    rng = np.random.default_rng(3)
    nof_rb, dft = 24, 512
    grid = _random_grid(rng, (12, nof_rb * 12))
    x = np.asarray(ofdm.modulate_slot(grid, SubcarrierSpacing.KHZ60, dft, CyclicPrefix.EXTENDED, 0))
    back = np.asarray(
        ofdm.demodulate_slot(x, nof_rb, SubcarrierSpacing.KHZ60, dft, CyclicPrefix.EXTENDED, 0)
    )
    np.testing.assert_allclose(back, grid, atol=2e-3)


def test_dft_window_offset_roundtrip():
    rng = np.random.default_rng(5)
    nof_rb, dft = 24, 512
    grid = _random_grid(rng, (14, nof_rb * 12))
    x = np.asarray(ofdm.modulate_slot(grid, SubcarrierSpacing.KHZ15, dft, CyclicPrefix.NORMAL, 0))
    back = np.asarray(
        ofdm.demodulate_slot(x, nof_rb, SubcarrierSpacing.KHZ15, dft, CyclicPrefix.NORMAL, 0,
                             window_offset=0.5)
    )
    np.testing.assert_allclose(back, grid, atol=3e-3)


def test_dft_matches_numpy_all_sizes():
    """ops/ofdm's forward and normalized inverse DFT against NumPy's for
    every DFT size the carriers use (f32 rounding: 2e-5 of the peak)."""
    import jax.numpy as jnp

    from srsran_project_tpu.ops import ofdm as ofdm_mod

    rng = np.random.default_rng(0)
    for n in (128, 256, 512, 1024, 2048, 4096):
        x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
             ).astype(np.complex64)
        xj = jnp.asarray(x)
        fwd = np.asarray(ofdm_mod._fft(xj))
        ref = np.fft.fft(x, axis=-1)
        assert np.abs(fwd - ref).max() / np.abs(ref).max() < 2e-5, n
        inv = np.asarray(ofdm_mod._ifft(xj))
        refi = np.fft.ifft(x, axis=-1)
        assert np.abs(inv - refi).max() / max(np.abs(refi).max(), 1e-9) < 2e-5, n
