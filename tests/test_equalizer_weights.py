"""4x4 MMSE equalizer weights (ops/equalizer.equalize_weights: the
structure-of-arrays form, and the generic batched-matmul form) against a
float64 oracle.

Every product is pinned to HIGHEST precision: a default-precision f32
matmul may run in reduced precision on an accelerator (TF32 on a GPU),
and the inverse's conditioning amplifies that to O(1) weight error.  The
CPU always computes in full f32, so these bounds hold on every backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srsran_project_tpu.ops.equalizer import _weights_generic, equalize_weights


def _rand_h(nsc, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((nsc, 4, 4))
             + 1j * rng.standard_normal((nsc, 4, 4))) * 0.5
            ).astype(np.complex64)


def _oracle64(h, nv):
    h64 = h.astype(np.complex128)
    w = np.empty_like(h64)
    ev = np.empty(h.shape[:1] + (4,), np.float64)
    for i in range(h.shape[0]):
        H = h64[i]
        G = H.conj().T @ H
        C = G + nv * np.eye(4)
        Ci = np.linalg.inv(C)
        mu = np.clip(np.real(np.einsum("ij,ji->i", Ci, G)), 1e-9, 1 - 1e-9)
        w[i] = (Ci @ H.conj().T) / mu[:, None]
        ev[i] = (1.0 - mu) / mu
    return w, ev


# Tolerances: f32 weights of random (not ill-conditioned) 4x4 channels
# reach ~1e-5 relative error; 1e-2 absolute bounds the worst subcarrier
# of 3276 with margin, and is far below the O(1) error of a reduced-
# precision product.
@pytest.mark.parametrize("nsc", [512, 700, 3276])
def test_weights_match_f64_oracle(nsc):
    h = _rand_h(nsc)
    nv = 0.013
    w_ref, ev_ref = _oracle64(h, nv)
    w, ev = equalize_weights(jnp.asarray(h), jnp.float32(nv))
    assert np.abs(np.asarray(w) - w_ref).max() < 1e-2
    assert np.abs(np.asarray(ev) - ev_ref).max() < 1e-2


def test_generic_weights_match_f64_oracle():
    """The batched-matmul form (other port/layer counts): same weights."""
    nsc = 700
    h = _rand_h(nsc, seed=3)
    nv = 0.013
    w_ref, ev_ref = _oracle64(h, nv)
    w, ev = jax.jit(_weights_generic)(jnp.asarray(h), jnp.float32(nv))
    assert np.abs(np.asarray(w) - w_ref).max() < 1e-2
    assert np.abs(np.asarray(ev) - ev_ref).max() < 1e-2


def test_xla_weights_match_f64_oracle():
    """Regression for the precision pin at a second noise level."""
    nsc = 700
    h = _rand_h(nsc, seed=4)
    nv = 0.05
    w_ref, _ = _oracle64(h, nv)
    w0, _ = equalize_weights(jnp.asarray(h), jnp.float32(nv))
    assert np.abs(np.asarray(w0) - w_ref).max() < 1e-2


def test_weights_under_vmap():
    hs = np.stack([_rand_h(512, seed=s) for s in range(3)])
    nv = 0.02
    w, e = jax.vmap(lambda hh: equalize_weights(hh, jnp.float32(nv)))(jnp.asarray(hs))
    for s in range(3):
        w_ref, ev_ref = _oracle64(hs[s], nv)
        assert np.abs(np.asarray(w[s]) - w_ref).max() < 1e-2
        assert np.abs(np.asarray(e[s]) - ev_ref).max() < 1e-2
