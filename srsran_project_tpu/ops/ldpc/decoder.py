"""LDPC decoder: layered normalized min-sum (counterpart of the reference's
ldpc_decoder_generic/avx2/avx512, lib/phy/upper/channel_coding/ldpc/
ldpc_decoder_impl.cpp) as plain JAX: the portable path, and the reference
that the GPU kernel (decoder_cuda.py) is checked against.

Layout: the a-posteriori LLRs live as one flat (batch, NB*Z + 1) f32 vector
(last slot is a scatter sink for padded edges).  Each check layer's
variable-node access — "pick block c, rotate by s" — is a single precomputed
flat gather index matrix (Dmax, Z), so one layer update is: gather,
extrinsic-subtract, two-level min reduction, scaled sign-magnitude update,
scatter.  Layers run under `lax.scan` (the schedule is inherently
sequential); iterations under `lax.fori_loop`; codewords batch in the
leading axis.

Numerics follow the reference semantics: channel LLRs clamped to ±64 on
load (ldpc_decoder_impl.h:205), punctured systematic blocks enter as 0,
normalized min-sum scaling factor 0.8 (ldpc_decoder_impl.h:198), hard
decision bit = 1 iff LLR < 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import graphs

SCALING = 0.8
INPUT_CLAMP = 64.0


@functools.lru_cache(maxsize=None)
def _layer_tables(bg: int, z: int, nof_layers: int):
    """Precompute per-layer gather tables.

    Returns (flat_idx (L, Dmax, Z) int32, valid (L, Dmax, 1) bool).
    flat index = col*Z + (zpos + shift) % Z; padded edges point at the
    sink slot NB*Z.
    """
    g = graphs.get_graph(bg, z)
    rows = [g.row_edges(r) for r in range(nof_layers)]
    dmax = max(len(r) for r in rows)
    nb = g.n
    sink = nb * z
    idx = np.full((nof_layers, dmax, z), sink, dtype=np.int32)
    valid = np.zeros((nof_layers, dmax, 1), dtype=bool)
    zidx = np.arange(z)
    for l, edges in enumerate(rows):
        for e, (col, shift) in enumerate(edges):
            idx[l, e] = col * z + (zidx + shift) % z
            valid[l, e, 0] = True
    return idx, valid


@functools.partial(
    jax.jit, static_argnames=("bg", "z", "nof_iterations", "nof_layers", "n_cb")
)
def decode(
    llrs: jax.Array,
    bg: int,
    z: int,
    nof_iterations: int = 6,
    nof_layers: int | None = None,
    n_cb: int | None = None,
):
    """Decode rate-dematched codeword LLRs.

    llrs: (batch, N) with N = (n-2)*Z — the circular-buffer positions
          (punctured 2Z systematic bits NOT included; they are re-inserted
          as zeros here).  Positive LLR means bit 0.
    n_cb: LBRM circular-buffer length; decodes only the check rows that
          can reach the message (graphs.active_layers, bit-exact for the
          message bits).
    Returns (bits (batch, K) uint8, app (batch, N_full) f32 final LLRs).
    """
    g = graphs.get_graph(bg, z)
    nof_layers = graphs.active_layers(g, n_cb, nof_layers)
    nb = g.n
    batch = llrs.shape[0]

    idx_np, valid_np = _layer_tables(bg, z, nof_layers)
    idx = jnp.asarray(idx_np)
    valid = jnp.asarray(valid_np)
    dmax = idx.shape[1]

    x = jnp.clip(llrs.astype(jnp.float32), -INPUT_CLAMP, INPUT_CLAMP)
    app = jnp.concatenate(
        [jnp.zeros((batch, 2 * z), jnp.float32), x, jnp.zeros((batch, 1), jnp.float32)],
        axis=-1,
    )  # (batch, NB*Z + 1)

    # The zero scaled by a data-derived scalar keeps r0's device-varying
    # type aligned with app under shard_map (psum/pcast rules).
    r0 = jnp.zeros((nof_layers, batch, dmax, z), jnp.float32) + 0.0 * x[0, 0]

    def layer_step(app, inputs):
        layer_idx, layer_valid, r_l = inputs  # (Dmax, Z), (Dmax, 1), (B, Dmax, Z)
        flat = layer_idx.reshape(-1)
        gathered = app[:, flat].reshape(batch, dmax, z)
        v = gathered - r_l
        absv = jnp.where(layer_valid, jnp.abs(v), jnp.inf)
        neg = jnp.where(layer_valid, v < 0, False)
        total_sign = jnp.where(jnp.sum(neg, axis=1, keepdims=True) % 2 == 1, -1.0, 1.0)
        m1 = jnp.min(absv, axis=1, keepdims=True)
        is_min = absv == m1
        # Second minimum: if the minimum occurs on 2+ edges, every edge's
        # "min over the others" equals m1; otherwise mask the unique min.
        m2 = jnp.min(jnp.where(is_min, jnp.inf, absv), axis=1, keepdims=True)
        nof_min = jnp.sum(is_min, axis=1, keepdims=True)
        m2 = jnp.where((nof_min > 1) | jnp.isinf(m2), m1, m2)
        mag = jnp.where(is_min, m2, m1)
        sign_v = jnp.where(v < 0, -1.0, 1.0)
        r_new = SCALING * total_sign * sign_v * mag
        r_new = jnp.where(layer_valid, r_new, 0.0)
        newval = v + r_new
        out = jnp.where(layer_valid, newval, gathered).reshape(batch, -1)
        app = app.at[:, flat].set(out)
        return app, r_new

    def iteration(_, carry):
        app, r = carry
        app, r = jax.lax.scan(layer_step, app, (idx, valid, r))
        return app, r

    app, r = jax.lax.fori_loop(0, nof_iterations, iteration, (app, r0))

    full = app[:, : nb * z]
    bits = (full[:, : g.kb * z] < 0).astype(jnp.uint8)
    return bits, full


def decode_count_iters(
    llrs: jax.Array,
    bg: int,
    z: int,
    nof_iterations: int = 6,
):
    """Like decode(), additionally returning per-codeblock convergence
    iteration counts: the first iteration (1-based) whose hard decision
    satisfies every parity check, or ``nof_iterations`` if none does —
    the same syndrome-stop statistic the GPU decoder kernel reports, for
    LDPC iteration parity against the reference's per-CB stats
    (ldpc_decoder stats in pusch_decoder_impl / pxsch_bler_test.cpp:375).
    All iterations still execute (no data-dependent trip count inside
    jit); only the COUNT reflects convergence.

    Returns (bits (B, K) uint8, app (B, N_full) f32, iters (B,) int32).
    """
    g = graphs.get_graph(bg, z)
    nof_layers = g.m
    nb = g.n
    batch = llrs.shape[0]

    idx_np, valid_np = _layer_tables(bg, z, nof_layers)
    idx = jnp.asarray(idx_np)
    valid = jnp.asarray(valid_np)
    dmax = idx.shape[1]

    x = jnp.clip(llrs.astype(jnp.float32), -INPUT_CLAMP, INPUT_CLAMP)
    app = jnp.concatenate(
        [jnp.zeros((batch, 2 * z), jnp.float32), x, jnp.zeros((batch, 1), jnp.float32)],
        axis=-1,
    )
    r0 = jnp.zeros((nof_layers, batch, dmax, z), jnp.float32) + 0.0 * x[0, 0]

    def layer_step(app, inputs):
        layer_idx, layer_valid, r_l = inputs
        flat = layer_idx.reshape(-1)
        gathered = app[:, flat].reshape(batch, dmax, z)
        v = gathered - r_l
        absv = jnp.where(layer_valid, jnp.abs(v), jnp.inf)
        neg = jnp.where(layer_valid, v < 0, False)
        total_sign = jnp.where(jnp.sum(neg, axis=1, keepdims=True) % 2 == 1, -1.0, 1.0)
        m1 = jnp.min(absv, axis=1, keepdims=True)
        is_min = absv == m1
        m2 = jnp.min(jnp.where(is_min, jnp.inf, absv), axis=1, keepdims=True)
        nof_min = jnp.sum(is_min, axis=1, keepdims=True)
        m2 = jnp.where((nof_min > 1) | jnp.isinf(m2), m1, m2)
        mag = jnp.where(is_min, m2, m1)
        sign_v = jnp.where(v < 0, -1.0, 1.0)
        r_new = SCALING * total_sign * sign_v * mag
        r_new = jnp.where(layer_valid, r_new, 0.0)
        newval = v + r_new
        out = jnp.where(layer_valid, newval, gathered).reshape(batch, -1)
        app = app.at[:, flat].set(out)
        return app, r_new

    def syndrome_ok(app):
        hard = (app < 0).astype(jnp.int32)  # (B, NB*Z+1)

        def layer_syn(layer_idx, layer_valid):
            flat = layer_idx.reshape(-1)
            g_h = hard[:, flat].reshape(batch, dmax, z)
            return jnp.sum(jnp.where(layer_valid, g_h, 0), axis=1) % 2  # (B, Z)

        syn = jax.vmap(layer_syn)(idx, valid)  # (L, B, Z)
        return jnp.sum(syn, axis=(0, 2)) == 0  # (B,)

    def iteration(carry, _):
        app, r = carry
        app, r = jax.lax.scan(layer_step, app, (idx, valid, r))
        return (app, r), syndrome_ok(app)

    (app, r), oks = jax.lax.scan(iteration, (app, r0), None,
                                 length=nof_iterations)  # oks: (I, B)
    first = jnp.argmax(oks, axis=0) + 1
    iters = jnp.where(oks.any(axis=0), first,
                      nof_iterations).astype(jnp.int32)

    full = app[:, : nb * z]
    bits = (full[:, : g.kb * z] < 0).astype(jnp.uint8)
    return bits, full, iters


# ---------------------------------------------------------------------------
# Reference-exact int8 mode
# ---------------------------------------------------------------------------

LLR_INF = 127  # fixed-bit marker (log_likelihood_ratio.h:250)
LLR_MAX = 120  # saturation bound (log_likelihood_ratio.h:255)


def _sat_add(a: jax.Array, b: jax.Array) -> jax.Array:
    """Reference saturated LLR sum (log_likelihood_ratio.cpp operator+=):
    a == -b -> 0; ±INF operands pass through; else clip(a+b, ±LLR_MAX)."""
    plain = jnp.clip(a + b, -LLR_MAX, LLR_MAX)
    out = jnp.where(jnp.abs(b) == LLR_INF, b, plain)
    out = jnp.where(jnp.abs(a) == LLR_INF, a, out)
    return jnp.where(a == -b, 0, out)


def _promotion_sum(a: jax.Array, b: jax.Array) -> jax.Array:
    """Reference promotion sum: like _sat_add but overflow promotes to ±INF
    (log_likelihood_ratio.cpp promotion_sum)."""
    s = a + b
    plain = jnp.where(jnp.abs(s) > LLR_MAX, jnp.sign(s) * LLR_INF, s)
    out = jnp.where(jnp.abs(b) == LLR_INF, b, plain)
    out = jnp.where(jnp.abs(a) == LLR_INF, a, out)
    return jnp.where(a == -b, 0, out)


@functools.partial(jax.jit, static_argnames=("bg", "z", "nof_iterations", "nof_layers"))
def decode_i8(
    llrs: jax.Array,
    bg: int,
    z: int,
    nof_iterations: int = 6,
    nof_layers: int | None = None,
):
    """Bit-exact re-expression of the reference's int8 layered min-sum
    decoder (ldpc_decoder_generic.cpp semantics) on int32 lanes.

    llrs: (batch, N) int8/int32 circular-buffer LLRs (no punctured 2Z bits).
    Returns (bits (batch, K) uint8, app (batch, NB*Z) int32 final LLRs).

    Numerics (all asserted against reference goldens):
    - input clamped to ±64 on load (ldpc_decoder_impl.h:205-207);
    - var-to-check = saturated difference with ±127 pass-through;
    - check-to-var magnitude = round(0.8f * min) half away from zero,
      ±127 kept as ±127 (ldpc_decoder_generic.cpp scale_llr);
    - soft bits = promotion sum (overflow -> ±127 fixed bits).
    """
    g = graphs.get_graph(bg, z)
    if nof_layers is None:
        nof_layers = g.m
    nb = g.n
    batch = llrs.shape[0]

    idx_np, valid_np = _layer_tables(bg, z, nof_layers)
    idx = jnp.asarray(idx_np)
    valid = jnp.asarray(valid_np)
    dmax = idx.shape[1]

    x = jnp.clip(llrs.astype(jnp.int32), -int(INPUT_CLAMP), int(INPUT_CLAMP))
    app = jnp.concatenate(
        [jnp.zeros((batch, 2 * z), jnp.int32), x, jnp.zeros((batch, 1), jnp.int32)],
        axis=-1,
    )
    r0 = jnp.zeros((nof_layers, batch, dmax, z), jnp.int32) + 0 * x[0, 0]

    big = jnp.int32(1 << 20)

    def layer_step(app, inputs):
        layer_idx, layer_valid, r_l = inputs
        flat = layer_idx.reshape(-1)
        gathered = app[:, flat].reshape(batch, dmax, z)
        v = _sat_add(gathered, -r_l)
        # The reference's min registers start at LLR_MAX with strict '<'
        # updates (ldpc_decoder_impl.cpp:258 srsvec::fill(min, LLR_MAX)), so
        # check minima are capped at 120 and ±127 never wins the min.
        absv = jnp.where(layer_valid, jnp.minimum(jnp.abs(v), LLR_MAX), big)
        neg = jnp.where(layer_valid, v < 0, False)
        total_sign_odd = jnp.sum(neg, axis=1, keepdims=True) % 2 == 1
        m1 = jnp.min(absv, axis=1, keepdims=True)
        is_min = absv == m1
        m2 = jnp.min(jnp.where(is_min, big, absv), axis=1, keepdims=True)
        nof_min = jnp.sum(is_min, axis=1, keepdims=True)
        m2 = jnp.where((nof_min > 1) | (m2 >= big), m1, m2)
        m2 = jnp.minimum(m2, LLR_MAX)
        mag = jnp.where(is_min, m2, m1)
        # scale_llr: round(0.8f * min) half away from zero (min <= 120).
        magf = mag.astype(jnp.float32) * np.float32(SCALING)
        scaled = jnp.floor(magf + np.float32(0.5)).astype(jnp.int32)
        own_neg = v < 0
        c2v_neg = total_sign_odd ^ own_neg
        r_new = jnp.where(c2v_neg, -scaled, scaled)
        r_new = jnp.where(layer_valid, r_new, 0)
        newval = _promotion_sum(v, r_new)
        out = jnp.where(layer_valid, newval, gathered).reshape(batch, -1)
        app = app.at[:, flat].set(out)
        return app, r_new

    def iteration(_, carry):
        app, r = carry
        app, r = jax.lax.scan(layer_step, app, (idx, valid, r))
        return app, r

    app, _ = jax.lax.fori_loop(0, nof_iterations, iteration, (app, r0))

    full = app[:, : nb * z]
    # Reference hard decision: bit = 1 iff llr <= 0 (log_likelihood_ratio.cpp:120).
    bits = (full[:, : g.kb * z] <= 0).astype(jnp.uint8)
    return bits, full
