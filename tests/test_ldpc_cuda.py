"""The GPU LDPC decoder kernel (ops/ldpc/decoder_cuda.py).

A CUDA kernel has no interpret mode: on the CPU its algorithm is checked
through `reference_model`, the kernel's steps in NumPy (compressed min-sum
state, rotated column access, per-codeblock early stop), against the plain
XLA decoder.  Tests marked `gpu` run the kernel itself on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srsran_project_tpu.ops.ldpc import decoder, decoder_cuda, encoder, graphs


def _noisy_llrs(bg, z, n, sigma, seed, n_cb=None):
    g = graphs.get_graph(bg, z)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, size=(n, g.kb * z), dtype=np.uint8)
    tx = np.asarray(encoder.encode(msg, bg, z))[:, 2 * z:]
    y = 1.0 - 2.0 * tx + sigma * rng.standard_normal(tx.shape)
    llr = np.clip(np.round(8.0 * y), -127, 127).astype(np.int8)
    if n_cb is not None:
        llr[:, n_cb:] = 0
    return msg, llr


@pytest.mark.parametrize("bg,z", [(2, 52), (1, 96)])
def test_cuda_decoder_noiseless(bg, z):
    g = graphs.get_graph(bg, z)
    rng = np.random.default_rng(z)
    msg = rng.integers(0, 2, size=(3, g.kb * z), dtype=np.uint8)
    cw = np.asarray(encoder.encode(msg, bg, z))
    llr = np.where(cw[:, 2 * z:] == 0, 20, -20).astype(np.int8)
    bits, iters = decoder_cuda.reference_model(llr, bg, z, nof_iterations=4)
    np.testing.assert_array_equal(bits, msg)
    np.testing.assert_array_equal(iters, 4)


def test_cuda_matches_xla_decoder_awgn():
    """Same schedule and arithmetic: hard bits equal the plain decoder's on
    every codeblock, including ones that do not converge."""
    bg, z = 2, 64
    _, llr = _noisy_llrs(bg, z, 6, 0.75, 0)
    ref, _ = decoder.decode(llr.astype(np.float32), bg, z, nof_iterations=5)
    got, _ = decoder_cuda.reference_model(llr, bg, z, nof_iterations=5)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_cuda_leading_dims_and_lbrm_width():
    """Leading batch dims flow through; an LBRM-truncated graph reads only
    its own columns and matches the plain decoder given the same n_cb."""
    bg, z = 1, 96
    n_cb = 30 * z
    _, llr = _noisy_llrs(bg, z, 4, 0.6, 1, n_cb=n_cb)
    ref, _ = decoder.decode(llr.astype(np.float32), bg, z, 4, n_cb=n_cb)
    got, iters = decoder_cuda.reference_model(llr.reshape(2, 2, -1), bg, z, 4,
                                              n_cb=n_cb)
    assert got.shape == (2, 2, 22 * z) and iters.shape == (2, 2)
    np.testing.assert_array_equal(got.reshape(4, -1), np.asarray(ref))


def test_cuda_early_stop_syndrome():
    """Per-codeblock syndrome stop: converges in few iterations at high SNR
    with the same bits as the full budget; reports iterations run."""
    bg, z = 2, 64
    msg, llr = _noisy_llrs(bg, z, 4, 0.3, 3)
    bits, iters = decoder_cuda.reference_model(llr, bg, z, 8, early_stop=True)
    np.testing.assert_array_equal(bits, msg)
    assert int(iters.max()) <= 3

    msg, llr = _noisy_llrs(bg, z, 4, 0.7, 4)
    b_full, it_full = decoder_cuda.reference_model(llr, bg, z, 8)
    b_es, it_es = decoder_cuda.reference_model(llr, bg, z, 8, early_stop=True)
    ok = (b_full == msg).all(-1)
    assert ok.any()
    np.testing.assert_array_equal(b_es[ok], b_full[ok])
    assert (it_full == 8).all() and (it_es <= 8).all()


@pytest.mark.parametrize("bg", [1, 2])
def test_kernel_plan_fits_every_graph(bg):
    """Every lifting size's graph fits the kernel's parameter block (edge
    count, degree <= 19, 46 layers) and the shared-memory APP fits 227 KB."""
    for z in graphs.ALL_LIFTING_SIZES:
        nl, ncols, row_start, edge_col, edge_shift = decoder_cuda.kernel_plan(bg, z, None)
        assert edge_col.size <= decoder_cuda.MAX_EDGES
        assert int(np.diff(row_start).max()) <= 19 and nl <= 46
        assert ((edge_shift >= 0) & (edge_shift < z)).all()
        assert edge_col.max() < ncols and ncols * z * 4 <= 227 * 1024


def test_cuda_decode_rejects_float_llrs():
    with pytest.raises(TypeError, match="int8"):
        decoder_cuda.decode(jnp.zeros((1, 50 * 52), jnp.float32), 2, 52)


def test_missing_nvcc_fails_loudly(tmp_path, monkeypatch):
    """No silent fallback: a GPU decode that cannot build its kernel raises."""
    monkeypatch.setattr(decoder_cuda, "LIBRARY", str(tmp_path / "missing.so"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        decoder_cuda.build()


@pytest.mark.gpu
def test_gpu_kernel_matches_plain_decoder(gpu):
    """On the card: kernel bits == plain decoder bits, fixed iterations, at
    the flagship geometry (BG1 Z=384, LBRM n_cb) and under vmap."""
    bg, z, n_cb = 1, 384, 13595
    _, llr = _noisy_llrs(bg, z, 8, 0.5, 5, n_cb=n_cb)
    ref, _ = decoder.decode(jnp.asarray(llr, jnp.float32), bg, z, 6, n_cb=n_cb)
    got, iters = decoder_cuda.decode(jnp.asarray(llr), bg, z, 6, n_cb=n_cb)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert (np.asarray(iters) == 6).all()
    f = jax.vmap(lambda x: decoder_cuda.decode(x, bg, z, 6, n_cb=n_cb)[0])
    got_v = f(jnp.asarray(llr).reshape(2, 4, -1))
    np.testing.assert_array_equal(np.asarray(got_v).reshape(8, -1), np.asarray(ref))


@pytest.mark.gpu
def test_gpu_kernel_matches_model_early_stop(gpu):
    bg, z = 2, 64
    _, llr = _noisy_llrs(bg, z, 16, 0.7, 6)
    want_bits, want_iters = decoder_cuda.reference_model(llr, bg, z, 8, early_stop=True)
    got, iters = decoder_cuda.decode(jnp.asarray(llr), bg, z, 8, early_stop=True)
    np.testing.assert_array_equal(np.asarray(got), want_bits)
    np.testing.assert_array_equal(np.asarray(iters), want_iters)
