"""MIMO channel equalization: ZF and MMSE, any ports x layers layout.

Counterpart of the reference's channel_equalizer_generic_impl
(lib/phy/upper/equalization/channel_equalizer_generic_impl.cpp) — which
hand-templates ZF 1-2 layers x 1/2/4 ports and stubs 3x4/4x4 behind an
enterprise flag — as one batched linear-algebra program: RE-batched
(H^H H + c I) closed-form solves for every (ports, layers) combination
uniformly, so full N-layer MMSE comes for free.

Inputs per RE: y (ports,), H (ports, layers), noise variance; outputs the
unbiased symbol estimates and the equivalent post-equalization noise
variance 1/SINR_l that the soft demapper consumes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def BATCH2(x):
    """dot_general batch-dims spec: all leading dims of x (and the other
    operand) are batch dims for the trailing 2-D matmul."""
    nb = tuple(range(x.ndim - 2))
    return (nb, nb)


def _inv2(c):
    """Closed-form inverse of (..., 2, 2) complex matrices."""
    a = c[..., 0, 0]
    b = c[..., 0, 1]
    d = c[..., 1, 0]
    e = c[..., 1, 1]
    det = a * e - b * d
    r = 1.0 / det
    row0 = jnp.stack([e * r, -b * r], axis=-1)
    row1 = jnp.stack([-d * r, a * r], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def _inv_small(c: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., L, L) matrices, L in {1, 2, 3, 4}.

    jnp.linalg.inv on batches of tiny matrices lowers to a looped LU
    factorization; blocked 2x2 Schur complements are pure vectorized
    elementwise math.  L=3 pads to 4 with an identity corner
    (block-diagonal, so the padded inverse embeds the answer)."""
    nl = c.shape[-1]
    if nl == 1:
        return 1.0 / c
    if nl == 2:
        return _inv2(c)
    if nl == 3:
        pad = jnp.zeros(c.shape[:-2] + (4, 4), c.dtype)
        pad = pad.at[..., :3, :3].set(c)
        pad = pad.at[..., 3, 3].set(1.0)
        return _inv_small(pad)[..., :3, :3]
    if nl == 4:
        # All 2x2 products at HIGHEST precision: a reduced-precision
        # product puts ~1e-3..1e-2 error on each entry, which the inverse's
        # conditioning amplifies to O(1..10) absolute error (measured
        # against a float64 oracle).
        def _mm(x, y):
            nb = tuple(range(x.ndim - 2))
            return jax.lax.dot_general(
                x, y, (((x.ndim - 1,), (y.ndim - 2,)), (nb, nb)),
                precision=jax.lax.Precision.HIGHEST)

        a = c[..., :2, :2]
        b = c[..., :2, 2:]
        bh = c[..., 2:, :2]
        d = c[..., 2:, 2:]
        ai = _inv2(a)
        s = d - _mm(_mm(bh, ai), b)  # Schur complement of A
        si = _inv2(s)
        aib = _mm(ai, b)
        bhai = _mm(bh, ai)
        tl = ai + _mm(_mm(aib, si), bhai)
        tr = -_mm(aib, si)
        bl = -_mm(si, bhai)
        top = jnp.concatenate([tl, tr], axis=-1)
        bot = jnp.concatenate([bl, si], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)
    raise ValueError(f"L={nl} unsupported")


def _mmse4_soa(h, noise_var, tx_scaling):
    """4x4 MMSE algebra in structure-of-arrays layout: every entry of the
    4x4 matrices is its own (...,) array, so the algebra is elementwise
    over the RE axis (no batched 4x4 matrix products).

    Returns (ci, g, bias mu per layer) with ci = (beta^2 G + sigma^2 I)^-1
    as nested lists [l][m] and g the Gram matrix H^H H."""
    L = P = 4
    nv = jnp.maximum(jnp.asarray(noise_var, h.real.dtype), 1e-12)
    beta2 = jnp.asarray(tx_scaling, h.real.dtype) ** 2
    hc = [[h[..., p, l] for l in range(L)] for p in range(P)]
    g = [[sum(jnp.conj(hc[p][l]) * hc[p][m] for p in range(P)) for m in range(L)]
         for l in range(L)]
    c = [[beta2 * g[l][m] + (nv if l == m else 0.0) for m in range(L)]
         for l in range(L)]

    def inv2(c00, c01, c10, c11):
        det = c00 * c11 - c01 * c10
        r = 1.0 / det
        return c11 * r, -c01 * r, -c10 * r, c00 * r

    def mm2(a, b):
        return (a[0] * b[0] + a[1] * b[2], a[0] * b[1] + a[1] * b[3],
                a[2] * b[0] + a[3] * b[2], a[2] * b[1] + a[3] * b[3])

    A = (c[0][0], c[0][1], c[1][0], c[1][1])
    Bm = (c[0][2], c[0][3], c[1][2], c[1][3])
    Bh = (c[2][0], c[2][1], c[3][0], c[3][1])
    D = (c[2][2], c[2][3], c[3][2], c[3][3])
    Ai = inv2(*A)
    S = tuple(d - t for d, t in zip(D, mm2(mm2(Bh, Ai), Bm)))
    Si = inv2(*S)
    AiB = mm2(Ai, Bm)
    BhAi = mm2(Bh, Ai)
    TL = tuple(a + t for a, t in zip(Ai, mm2(mm2(AiB, Si), BhAi)))
    TR = tuple(-t for t in mm2(AiB, Si))
    BL = tuple(-t for t in mm2(Si, BhAi))
    ci = [[TL[0], TL[1], TR[0], TR[1]],
          [TL[2], TL[3], TR[2], TR[3]],
          [BL[0], BL[1], Si[0], Si[1]],
          [BL[2], BL[3], Si[2], Si[3]]]
    mu = [jnp.clip(sum((ci[l][m] * (beta2 * g[m][l])).real for m in range(L)),
                   1e-9, 1.0 - 1e-9) for l in range(L)]
    return ci, hc, mu


def _equalize_mmse4_soa(y, h, noise_var, tx_scaling):
    """4-layer MMSE per RE in structure-of-arrays layout (see _mmse4_soa).
    Same math as the generic MMSE branch."""
    L = P = 4
    ci, hc, mu = _mmse4_soa(h, noise_var, tx_scaling)
    yc = [y[..., p] for p in range(P)]
    z = [sum(jnp.conj(hc[p][l]) * yc[p] for p in range(P)) for l in range(L)]
    ts = jnp.asarray(tx_scaling, h.dtype)
    x = [sum(ci[l][m] * z[m] for m in range(L)) * ts for l in range(L)]
    xh = jnp.stack([x[l] / mu[l].astype(h.dtype) for l in range(L)], axis=-1)
    ev = jnp.stack([(1.0 - mu[l]) / mu[l] for l in range(L)], axis=-1)
    return xh, ev


def _weights_mmse4_soa(h, noise_var, tx_scaling=1.0):
    """equalize_weights' 4x4 MMSE in structure-of-arrays layout."""
    L = P = 4
    ci, hc, mu = _mmse4_soa(h, noise_var, tx_scaling)
    ts = jnp.asarray(tx_scaling, h.dtype)
    w = jnp.stack([jnp.stack(
        [sum(ci[l][m] * jnp.conj(hc[p][m]) for m in range(L)) * ts
         / mu[l].astype(h.dtype) for p in range(P)], axis=-1) for l in range(L)],
        axis=-2)
    ev = jnp.stack([(1.0 - mu[l]) / mu[l] for l in range(L)], axis=-1)
    return w, ev


@functools.partial(jax.jit, static_argnames=("method",))
def equalize_weights(
    h: jax.Array,
    noise_var: jax.Array,
    tx_scaling: float | jax.Array = 1.0,
    method: str = "mmse",
):
    """Per-position equalizer weights for a batch of channel matrices.

    h: (..., P, L); noise_var: broadcastable to (...,).
    Returns (w (..., L, P), eq_nvar (..., L)) such that x_hat = w @ y is
    the unbiased estimate with post-equalization noise eq_nvar — the same
    math as `equalize`, factored so callers whose channel varies on a
    COARSER axis than their data (PxSCH: h per subcarrier, data per
    (symbol, subcarrier)) invert each distinct matrix once instead of per
    RE.  At the 100 MHz 13-symbol slot that is 12x less inverse work than
    the per-RE formulation.

    4x4 MMSE takes the structure-of-arrays form: the batched 4x4
    dot_generals of the generic form become cuBLAS batched GEMMs on the
    GPU, which XLA cannot fuse with the elementwise inverse around them.
    """
    if h.shape[-1] == 4 and h.shape[-2] == 4 and method == "mmse":
        return _weights_mmse4_soa(h, noise_var, tx_scaling)
    return _weights_generic(h, noise_var, tx_scaling, method)


def _weights_generic(h, noise_var, tx_scaling=1.0, method="mmse"):
    """equalize_weights for any ports x layers, with batched matmuls."""
    nlayers = h.shape[-1]
    hh = jnp.conj(jnp.swapaxes(h, -1, -2))  # (..., L, P)
    # HIGHEST precision: a reduced-precision f32 product (TF32 on a GPU)
    # on these small matmuls costs O(1) absolute weight error on
    # conditioned channels (measured against a float64 oracle).
    gram = jax.lax.dot_general(
        hh, h, (((hh.ndim - 1,), (h.ndim - 2,)), BATCH2(hh)),
        precision=jax.lax.Precision.HIGHEST)
    nv = jnp.maximum(jnp.asarray(noise_var, h.real.dtype), 1e-12)[..., None]
    beta2 = jnp.asarray(tx_scaling, h.real.dtype) ** 2
    eye = jnp.eye(nlayers, dtype=h.dtype)
    if method == "mmse":
        c = beta2 * gram + nv[..., None] * eye
    elif method == "zf":
        c = beta2 * gram + 1e-9 * eye
    else:
        raise ValueError(method)
    cinv = _inv_small(c)
    w = jax.lax.dot_general(
        cinv, hh, (((cinv.ndim - 1,), (hh.ndim - 2,)), BATCH2(cinv)),
        precision=jax.lax.Precision.HIGHEST) * jnp.asarray(tx_scaling, h.dtype)
    if method == "mmse":
        mu = jnp.einsum("...ij,...ji->...i", cinv, beta2 * gram,
                        precision=jax.lax.Precision.HIGHEST).real
        mu = jnp.clip(mu, 1e-9, 1.0 - 1e-9)
        w = w / mu[..., None].astype(h.dtype)
        eq_nvar = (1.0 - mu) / mu
    else:
        diag = jnp.einsum("...ii->...i", cinv).real
        eq_nvar = nv * diag / beta2
    return w, eq_nvar


@functools.partial(jax.jit, static_argnames=("method",))
def equalize(
    y: jax.Array,
    h: jax.Array,
    noise_var: jax.Array,
    tx_scaling: float | jax.Array = 1.0,
    method: str = "mmse",
):
    """Equalize a batch of resource elements.

    y:         (..., nre, nof_ports) received symbols
    h:         (..., nre, nof_ports, nof_layers) channel estimates
    noise_var: broadcastable to (..., nre) noise variance (per RE)
    method:    "mmse" or "zf"

    Returns (x_hat (..., nre, nof_layers), eq_noise_var (..., nre, nof_layers)).
    eq_noise_var is the equivalent AWGN variance of the unbiased estimate
    (1/SINR); infinite-variance layers (ZF singularities) come out large.
    """
    nlayers = h.shape[-1]
    if nlayers == 4 and h.shape[-2] == 4 and method == "mmse":
        return _equalize_mmse4_soa(y, h, noise_var, tx_scaling)
    hh = jnp.conj(jnp.swapaxes(h, -1, -2))  # (..., L, P)
    gram = jax.lax.dot_general(
        hh, h, (((hh.ndim - 1,), (h.ndim - 2,)), BATCH2(hh)),
        precision=jax.lax.Precision.HIGHEST)  # (..., L, L)
    hp = jax.lax.Precision.HIGHEST
    z = jnp.matmul(hh, y[..., None], precision=hp)[..., 0]  # (..., L) matched filter
    nv = jnp.maximum(jnp.asarray(noise_var, h.real.dtype), 1e-12)[..., None]
    beta2 = jnp.asarray(tx_scaling, h.real.dtype) ** 2

    eye = jnp.eye(nlayers, dtype=h.dtype)
    if method == "mmse":
        c = beta2 * gram + nv[..., None] * eye
    elif method == "zf":
        # Tiny diagonal loading keeps the solve finite for singular layouts.
        c = beta2 * gram + 1e-9 * eye
    else:
        raise ValueError(method)

    cinv = _inv_small(c)  # (..., L, L); closed form, L <= 4
    xt = jnp.matmul(cinv, z[..., None], precision=hp)[..., 0] * jnp.asarray(
        tx_scaling, h.dtype)

    if method == "mmse":
        # Bias mu_l = [C^-1 (beta^2 G)]_ll; unbiased estimate and 1/SINR.
        mu = jnp.einsum("...ij,...ji->...i", cinv, beta2 * gram,
                        precision=jax.lax.Precision.HIGHEST).real
        mu = jnp.clip(mu, 1e-9, 1.0 - 1e-9)
        x_hat = xt / mu.astype(h.dtype)
        eq_nvar = (1.0 - mu) / mu
    else:
        x_hat = xt
        diag = jnp.einsum("...ii->...i", cinv).real
        eq_nvar = nv * diag / beta2
    return x_hat, eq_nvar


def equalize_ref(
    y: jax.Array,
    h: jax.Array,
    noise_var_port: jax.Array,
    tx_scaling: float = 1.0,
    method: str = "zf",
):
    """Reference-parity equalizer (channel_equalizer_generic_impl).

    y: (..., nre, P) received symbols; h: (..., nre, P, L) estimates;
    noise_var_port: (P,) per-port noise variance estimates.

    Semantics matched to the reference kernels:
    - L == 1 (both ZF and MMSE — the reference reduces 1-layer MMSE to ZF,
      channel_equalizer_generic_impl.cpp:341): per-port accumulation with
      per-port noise weighting and non-normal port exclusion
      (equalize_zf_1xn.h); nvar = sum(|h|^2 sigma_p) / (beta*sum|h|^2)^2.
    - L == 2 (ZF, P in {2,4}): adjugate solve with the most pessimistic
      (max) noise variance; nvar_l = sigma_max * [G^-1]_ll / beta
      (equalize_zf_2xn.h).
    Abnormal denominators yield (0, inf) like the reference.

    Returns (x_hat (..., nre, L), eq_noise_var (..., nre, L)).
    """
    import numpy as np

    nlayers = h.shape[-1]
    beta = jnp.float32(tx_scaling)
    tiny = np.float32(1.1754944e-38)  # smallest normal float32 (isnormal gate)
    inf = np.float32(np.inf)
    nv = jnp.asarray(noise_var_port, jnp.float32)

    def _isnormal(x):
        return jnp.isfinite(x) & (jnp.abs(x) >= tiny)

    if nlayers == 1:
        h1 = h[..., 0]  # (..., nre, P)
        norm = jnp.abs(h1) ** 2
        port_ok = _isnormal(norm) & _isnormal(nv) & (nv > 0)
        norm = jnp.where(port_ok, norm, 0.0)
        mf = jnp.where(port_ok, y * jnp.conj(h1), 0.0)
        ch_mod_sq = jnp.sum(norm, axis=-1)
        nvar_acc = jnp.sum(norm * nv, axis=-1)
        re_out = jnp.sum(mf, axis=-1)
        d_pinv = beta * ch_mod_sq
        ok = _isnormal(d_pinv) & _isnormal(nvar_acc)
        rcp = jnp.where(ok, 1.0 / jnp.where(ok, d_pinv, 1.0), 0.0)
        x = jnp.where(ok, re_out * rcp, 0.0)
        nvar = jnp.where(ok, nvar_acc * rcp * rcp, inf)
        return x[..., None], nvar[..., None]

    if nlayers == 2:
        sigma = jnp.max(nv)
        h0, h1 = h[..., 0], h[..., 1]  # (..., nre, P)
        g00 = jnp.sum(jnp.abs(h0) ** 2, axis=-1)
        g11 = jnp.sum(jnp.abs(h1) ** 2, axis=-1)
        xi = jnp.sum(h1 * jnp.conj(h0), axis=-1)
        m0 = jnp.sum(y * jnp.conj(h0), axis=-1)
        m1 = jnp.sum(y * jnp.conj(h1), axis=-1)
        d_pinv = beta * (g00 * g11 - jnp.abs(xi) ** 2)
        ok = _isnormal(d_pinv) & (d_pinv > 0)
        rcp = jnp.where(ok, 1.0 / jnp.where(ok, d_pinv, 1.0), 0.0)
        x0 = jnp.where(ok, (m0 * g11 - xi * m1) * rcp, 0.0)
        x1 = jnp.where(ok, (m1 * g00 - jnp.conj(xi) * m0) * rcp, 0.0)
        nv0 = jnp.where(ok, g11 * sigma * rcp, inf)
        nv1 = jnp.where(ok, g00 * sigma * rcp, inf)
        return jnp.stack([x0, x1], axis=-1), jnp.stack([nv0, nv1], axis=-1)

    raise ValueError(
        f"reference parity covers 1-2 layers (the open-source reference stubs "
        f"3-4 layer equalizers); got {nlayers} — use equalize() instead"
    )
