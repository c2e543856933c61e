"""Short-block codes for UCI of 1-11 bits (TS 38.212 §5.3.3 / §5.4.3).

Counterpart of the reference's short_block_encoder/detector
(lib/phy/upper/channel_coding/short/short_block_{encoder,detector}_impl.cpp).
K in [3, 11] uses the RM(32, K) code of Table 5.3.3.3-1; K in {1, 2} uses
the tiny repetition/simplex codes.  The ML detector is a single matmul
of the LLR vector against all 2^K candidate codewords — the batched
replacement for the reference's SIMD correlation search.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# TS 38.212 Table 5.3.3.3-1: 11 basis sequences M_{n,k} of length 32.
BASIS = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 0],
        [0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 0],
        [0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 1, 0],
        [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0],
        [0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0],
        [0, 0, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0],
        [0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0],
        [0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 0],
    ],
    dtype=np.uint8,
)


@functools.lru_cache(maxsize=None)
def _mother_codewords(k: int) -> np.ndarray:
    """(2^K, Ncode) all codewords of the K-bit short block code."""
    if k == 1:
        return np.array([[0], [1]], dtype=np.uint8)
    if k == 2:
        # Index decoding is LSB-first everywhere (matches detect()).
        msgs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.uint8)
        return np.stack([msgs[:, 0], msgs[:, 1], msgs[:, 0] ^ msgs[:, 1]], axis=1)
    idx = np.arange(1 << k)
    msgs = ((idx[:, None] >> np.arange(k)) & 1).astype(np.uint8)  # a_k LSB-first? see encode
    return (msgs @ BASIS[:k]) % 2


# Placeholder markers for K <= 2 (TS 38.212 §5.3.3.1/.2; reference
# short_block_encoder.h:40-45): "x" repeats the previous modulation symbol
# value, "y" repeats the previous bit after scrambling.
PLACEHOLDER_X = 255
PLACEHOLDER_Y = 254


def encode(msg: jax.Array, e: int, placeholders: bool = False) -> jax.Array:
    """(..., K) bits -> (..., E) coded bits (rate-matched by repetition).

    K = msg.shape[-1] in [1, 11]; for K in [3, 11] codeword
    d(n) = sum_k a_k M_{n,k} mod 2 (TS 38.212 §5.3.3.3).

    placeholders=True emits the spec's x/y markers (255/254) for K <= 2
    exactly like the reference encoder; E must then be Qm (K=1) or 3*Qm
    (K=2).  The markers are resolved later during scrambling.
    """
    k = msg.shape[-1]
    msg = msg.astype(jnp.uint8)
    if placeholders and k <= 2:
        batch = msg.shape[:-1]
        out = jnp.full(batch + (e,), PLACEHOLDER_X, jnp.uint8)
        if k == 1:
            out = out.at[..., 0].set(msg[..., 0])
            if e > 1:
                out = out.at[..., 1].set(PLACEHOLDER_Y)
            return out
        c2 = msg[..., 0] ^ msg[..., 1]
        out = out.at[..., 0].set(msg[..., 0])
        out = out.at[..., 1].set(msg[..., 1])
        if e == 3:
            return out.at[..., 2].set(c2)
        step = e // 3
        out = out.at[..., step].set(c2)
        out = out.at[..., step + 1].set(msg[..., 0])
        out = out.at[..., 2 * step].set(msg[..., 1])
        out = out.at[..., 2 * step + 1].set(c2)
        return out
    if k == 1:
        base = msg
    elif k == 2:
        base = jnp.concatenate([msg, (msg[..., :1] ^ msg[..., 1:2])], axis=-1)
    else:
        basis = jnp.asarray(BASIS[:k].astype(np.float32))
        base = (
            jnp.matmul(msg.astype(jnp.float32), basis, preferred_element_type=jnp.float32)
            .astype(jnp.int32)
            & 1
        ).astype(jnp.uint8)
    n = base.shape[-1]
    reps = -(-e // n)
    tiled = jnp.tile(base, (1,) * (base.ndim - 1) + (reps,))
    return tiled[..., :e]


@functools.partial(jax.jit, static_argnames=("k", "e"))
def detect(llrs: jax.Array, k: int, e: int):
    """ML detection of a K-bit short block from (..., E) LLRs.

    Returns (bits (..., K) uint8, metric (...,) float32 in [0, 1] — the
    normalized correlation of the winning candidate).
    """
    cw = _mother_codewords(k)
    n = cw.shape[1]
    # Fold repeated positions back onto the mother codeword (sum LLRs).
    reps = -(-e // n)
    pad = reps * n - e
    x = jnp.pad(llrs.astype(jnp.float32), [(0, 0)] * (llrs.ndim - 1) + [(0, pad)])
    folded = x.reshape(x.shape[:-1] + (reps, n)).sum(axis=-2)  # (..., n)
    signs = jnp.asarray(1.0 - 2.0 * cw.astype(np.float32))  # (2^K, n)
    # LLR-valued scores decide the winner: full f32 products, no TF32.
    scores = jnp.matmul(folded, signs.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
    best = jnp.argmax(scores, axis=-1)
    msgs = ((np.arange(1 << k)[:, None] >> np.arange(k)) & 1).astype(np.uint8)
    bits = jnp.asarray(msgs)[best]
    denom = jnp.sum(jnp.abs(folded), axis=-1) + 1e-9
    metric = jnp.take_along_axis(scores, best[..., None], axis=-1)[..., 0] / denom
    return bits, metric


def detect_ref(llrs: jax.Array, k: int, e: int, qm: int):
    """Reference-exact short-block detection on int8 LLRs
    (short_block_detector_impl.cpp): returns (bits (..., K) uint8,
    ok (...,) bool).

    Mirrors the reference's rate-dematch (saturated int8 fold onto the
    mother length), per-K detectors, and GLRT thresholds.
    """
    x = llrs.astype(jnp.int32)
    batch = x.shape[:-1]

    def sat_fold(vec, n):
        reps = -(-vec.shape[-1] // n)
        pad = reps * n - vec.shape[-1]
        v = jnp.pad(vec, [(0, 0)] * (vec.ndim - 1) + [(0, pad)])
        blocks = v.reshape(v.shape[:-1] + (reps, n))
        out = blocks[..., 0, :]
        for r in range(1, reps):
            b = blocks[..., r, :]
            plain = jnp.clip(out + b, -120, 120)
            res = jnp.where(jnp.abs(b) == 127, b, plain)
            res = jnp.where(jnp.abs(out) == 127, out, res)
            out = jnp.where(out == -b, 0, res)
        return out

    # The reference first rate-dematches E onto the MOTHER length (Qm for
    # 1 bit, 3*Qm for 2 bits, 32 otherwise) with saturating LLR folds
    # (short_block_detector_impl.cpp rate_dematch), THEN detects.  Folding
    # matters whenever E exceeds the mother length (repetition) — caught
    # by the round-5 uci_decoder golden suite (E=16 at QAM16, k=2).
    if k == 1:
        tmp = sat_fold(x, max(qm, 1))
        bit = (tmp[..., 0] <= 0).astype(jnp.uint8)
        return bit[..., None], jnp.ones(batch, bool)

    if k == 2:
        n = 3 * qm if qm > 1 else 3
        x2 = sat_fold(x, n)
        if n == 3:
            l0, l1, l2 = x2[..., 0], x2[..., 1], x2[..., 2]
        else:
            step = qm - 2
            l0 = x2[..., 0] + x2[..., step + 3]
            l1 = x2[..., 1] + x2[..., 2 * step + 4]
            l2 = x2[..., step + 2] + x2[..., 2 * step + 5]
        lv = jnp.stack([l0, l1, l2], axis=-1).astype(jnp.float64)
        table2 = jnp.asarray(
            np.array([[1, 1, 1], [-1, 1, -1], [1, -1, -1], [-1, -1, 1]], np.float64)
        )
        scores = jnp.matmul(lv, table2.T,
                            precision=jax.lax.Precision.HIGHEST)  # (..., 4)
        # Strict '>' against a tiny positive init: all-nonpositive -> idx 0.
        best = jnp.argmax(scores, axis=-1)
        best = jnp.where(jnp.max(scores, axis=-1) > 0, best, 0)
        bits = jnp.stack([best & 1, (best >> 1) & 1], axis=-1).astype(jnp.uint8)
        m = jnp.take_along_axis(scores, best[..., None], axis=-1)[..., 0]
        norm = jnp.sum(lv * lv, axis=-1)
        metric = 2.0 * m * m / (3.0 * norm - m * m)
        return bits, metric > 0.0  # THRESHOLDS[1] = 0

    folded = sat_fold(x, 32)
    nof_cw = 1 << (k - 1)
    idx = np.arange(nof_cw)
    msgs = (((2 * idx)[:, None] >> np.arange(11)) & 1).astype(np.uint8)  # LSB-first
    cw = (msgs @ BASIS) % 2  # (2^(K-1), 32)
    signs = jnp.asarray(1.0 - 2.0 * cw.astype(np.float64))
    scores = folded.astype(jnp.float64) @ signs.T  # (..., 2^(K-1))
    absval = jnp.abs(scores)
    best = jnp.argmax(absval, axis=-1)
    m = jnp.max(absval, axis=-1)
    bit0 = (jnp.take_along_axis(scores, best[..., None], axis=-1)[..., 0] < 0).astype(jnp.int32)
    full_idx = 2 * best + bit0
    bits = ((full_idx[..., None] >> jnp.arange(k)) & 1).astype(jnp.uint8)
    norm = jnp.sum(folded.astype(jnp.float64) ** 2, axis=-1)
    metric = 31.0 * m * m / (32.0 * norm - m * m)
    thresholds = (0, 0, 12, 14, 16, 18, 20, 22, 24, 26, 29)
    return bits, metric > thresholds[k - 1]
