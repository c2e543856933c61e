"""LDPC rate matching / dematching (TS 38.212 §5.4.2), gather/scatter-based.

Counterpart of the reference's ldpc_rate_matcher_impl / ldpc_rate_dematcher_*
(lib/phy/upper/channel_coding/ldpc/ldpc_rate_matcher_impl.cpp) — re-designed
as static tensor ops: for a static (bg, Z, K', E, rv, Qm, N_cb) configuration, the whole
bit-selection + interleaving pipeline collapses to one precomputed gather
index vector; dematching is the corresponding scatter-add with int8 LLR
saturation.  Redundancy versions and filler skipping cost nothing at runtime.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import graphs

# Redundancy-version starting offsets k0 = floor(num * N_cb / N) * Z
# (TS 38.212 Table 5.4.2.1-2): numerators per rv, over denominator 66 / 50.
_RV_NUM = {graphs.BG1: (0, 17, 33, 56), graphs.BG2: (0, 13, 25, 43)}
_DEN = {graphs.BG1: 66, graphs.BG2: 50}

LLR_MAX = 120  # "finite" LLR cap, matches reference log_likelihood_ratio.h
LLR_INF = 127  # marks known bits (e.g. filler positions)


def k0_offset(bg: int, z: int, rv: int, n_cb: int) -> int:
    num = _RV_NUM[bg][rv]
    return (num * n_cb // (_DEN[bg] * z)) * z


@functools.lru_cache(maxsize=None)
def selection_indices(
    bg: int, z: int, k_prime: int, e: int, rv: int, qm: int, n_cb: int | None = None
) -> np.ndarray:
    """(E,) int32 gather indices into the N-bit circular buffer d.

    Applies bit selection (circular, skipping filler positions) followed by
    the Qm-row block interleaver: out[j*qm + i] = e[i*(e//qm) + j].
    """
    g = graphs.get_graph(bg, z)
    n = g.nof_codeword_bits
    if n_cb is None:
        n_cb = n
    # Filler positions within the buffer: message tail [k_prime - 2Z, K - 2Z).
    f_start = k_prime - 2 * z
    f_end = g.kb * z - 2 * z
    is_filler = np.zeros(n_cb, dtype=bool)
    is_filler[f_start:f_end] = True
    k0 = k0_offset(bg, z, rv, n_cb)
    order = (k0 + np.arange(n_cb)) % n_cb
    valid = order[~is_filler[order]]
    reps = -(-e // len(valid))
    sel = np.tile(valid, reps)[:e].astype(np.int32)
    # Interleave: e viewed as (qm, e//qm), read column-major.
    assert e % qm == 0, (e, qm)
    sel = sel.reshape(qm, e // qm).T.reshape(-1)
    return sel


@functools.lru_cache(maxsize=None)
def _filler_mask(bg: int, z: int, k_prime: int, n_cb: int) -> np.ndarray:
    g = graphs.get_graph(bg, z)
    m = np.zeros(n_cb, dtype=bool)
    m[k_prime - 2 * z : g.kb * z - 2 * z] = True
    return m


@functools.lru_cache(maxsize=None)
def _valid_runs(bg: int, z: int, k_prime: int, rv: int, n_cb: int):
    """Maximal consecutive runs of the circular-buffer read order with
    fillers skipped: [(buf_start, length)], in read order.

    The whole bit-selection map is a handful of contiguous buffer slices
    (circular start + <= 2 filler splits + wraparound), so both matching
    and dematching collapse to static slice/concat/transpose — no device
    gather: slice+concat copies run at memory bandwidth, where an
    (N,)-index gather reads through an index array.
    """
    is_filler = _filler_mask(bg, z, k_prime, n_cb)
    k0 = k0_offset(bg, z, rv, n_cb)
    order = (k0 + np.arange(n_cb)) % n_cb
    valid = order[~is_filler[order]]
    cuts = np.nonzero(np.diff(valid) != 1)[0] + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [len(valid)]])
    return tuple((int(valid[s]), int(e_ - s)) for s, e_ in zip(starts, ends))


def _chunk_segments(bg: int, z: int, k_prime: int, e: int, rv: int, n_cb: int):
    """Per-repetition-chunk segment maps for E transmitted positions.

    Returns [(chunk_de_offset, [(buf_start, de_start, length), ...]), ...]
    where de indexes the DE-INTERLEAVED LLR/bit stream and each chunk
    covers one pass over the usable buffer (repetition when E > usable).
    """
    runs = _valid_runs(bg, z, k_prime, rv, n_cb)
    v = sum(ln for _, ln in runs)
    chunks = []
    off = 0
    while off < e:
        take = min(v, e - off)
        segs = []
        pos = 0
        for bs, ln in runs:
            if pos >= take:
                break
            ln_c = min(ln, take - pos)
            segs.append((bs, off + pos, ln_c))
            pos += ln_c
        chunks.append(segs)
        off += take
    return chunks


@functools.partial(jax.jit, static_argnames=("bg", "z", "k_prime", "e", "rv", "qm", "n_cb"))
def rate_match(
    buffer: jax.Array, bg: int, z: int, k_prime: int, e: int, rv: int, qm: int, n_cb: int | None = None
) -> jax.Array:
    """(..., N) codeword buffer -> (..., E) transmitted bits.

    Static slice/concat (read the buffer runs in circular order, tile for
    repetition) + reshape/transpose (the Qm block interleaver) — the
    gather-free formulation of TS 38.212 §5.4.2.
    """
    if n_cb is None:
        n_cb = graphs.get_graph(bg, z).nof_codeword_bits
    chunks = _chunk_segments(bg, z, k_prime, e, rv, n_cb)
    pieces = []
    for segs in chunks:
        for bs, _ds, ln in segs:
            pieces.append(buffer[..., bs : bs + ln])
    pre = jnp.concatenate(pieces, axis=-1)  # (..., E) in pre-interleave order
    # Interleave: out[j*qm + i] = pre[i*(e//qm) + j].
    out = pre.reshape(pre.shape[:-1] + (qm, e // qm))
    return jnp.swapaxes(out, -1, -2).reshape(pre.shape[:-1] + (e,))


def _dematch_accumulate(llrs: jax.Array, bg: int, z: int, k_prime: int,
                        e: int, rv: int, qm: int, n_cb: int) -> jax.Array:
    """(..., E) int8 LLRs -> (..., N) int32 accumulated buffer positions
    (filler/erasure handling left to the callers).  Gather-free: the
    de-interleave is a reshape/transpose and each repetition chunk is a
    static slice/concat in buffer order."""
    g = graphs.get_graph(bg, z)
    n = g.nof_codeword_bits
    batch = llrs.shape[:-1]
    # De-interleave: de[i*(e//qm) + j] = llrs[j*qm + i].
    de = llrs.reshape(batch + (e // qm, qm))
    de = jnp.swapaxes(de, -1, -2).reshape(batch + (e,)).astype(jnp.int32)
    acc = None
    for segs in _chunk_segments(bg, z, k_prime, e, rv, n_cb):
        pieces = []
        cur = 0
        for bs, ds, ln in sorted(segs):
            if bs > cur:
                pieces.append(jnp.zeros(batch + (bs - cur,), jnp.int32))
            pieces.append(de[..., ds : ds + ln])
            cur = bs + ln
        if cur < n:
            pieces.append(jnp.zeros(batch + (n - cur,), jnp.int32))
        chunk = jnp.concatenate(pieces, axis=-1)
        acc = chunk if acc is None else acc + chunk
    return acc


@functools.partial(jax.jit, static_argnames=("bg", "z", "k_prime", "e", "rv", "qm", "n_cb"))
def rate_dematch(
    llrs: jax.Array, bg: int, z: int, k_prime: int, e: int, rv: int, qm: int, n_cb: int | None = None
) -> jax.Array:
    """(..., E) int8 LLRs -> (..., N) codeword-buffer LLRs.

    Combines repeated transmissions of the same buffer position with int8
    saturation; filler positions are set to +LLR_INF (known zero bits).
    Positions never transmitted stay 0 (erasure).
    """
    g = graphs.get_graph(bg, z)
    n = g.nof_codeword_bits
    if n_cb is None:
        n_cb = n
    acc = _dematch_accumulate(llrs, bg, z, k_prime, e, rv, qm, n_cb)
    usable = sum(ln for _, ln in _valid_runs(bg, z, k_prime, rv, n_cb))
    if e > usable:  # repetition: saturate the combined sums
        acc = jnp.clip(acc, -LLR_MAX, LLR_MAX)
    filler = jnp.asarray(_filler_mask(bg, z, k_prime, n_cb))
    filler = jnp.pad(filler, (0, n - n_cb)) if n_cb < n else filler
    return jnp.where(filler, jnp.int32(LLR_INF), acc).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("bg", "z", "k_prime", "e", "rv", "qm", "n_cb"))
def rate_dematch_combine(
    buffer: jax.Array,
    llrs: jax.Array,
    bg: int,
    z: int,
    k_prime: int,
    e: int,
    rv: int,
    qm: int,
    n_cb: int | None = None,
) -> jax.Array:
    """HARQ retransmission: dematch `llrs` (..., E) and combine into the
    existing codeblock `buffer` (..., N) with int8 saturation at ±LLR_MAX.

    Mirrors the reference's allot_llrs combine mode
    (ldpc_rate_dematcher_impl.cpp:146-152): written positions add with
    saturation, filler positions keep +LLR_INF, untouched positions keep
    their previous value.
    """
    g = graphs.get_graph(bg, z)
    n = g.nof_codeword_bits
    if n_cb is None:
        n_cb = n
    inc = _dematch_accumulate(llrs, bg, z, k_prime, e, rv, qm, n_cb)
    filler = jnp.asarray(_filler_mask(bg, z, k_prime, n_cb))
    filler = jnp.pad(filler, (0, n - n_cb)) if n_cb < n else filler
    combined = jnp.clip(buffer.astype(jnp.int32) + inc, -LLR_MAX, LLR_MAX)
    return jnp.where(filler, jnp.int32(LLR_INF), combined).astype(jnp.int8)


def combine_harq(old: jax.Array, new: jax.Array) -> jax.Array:
    """Saturating int8 LLR combine of a retransmission into the HARQ buffer
    (reference: pusch_decoder_impl.cpp:336; log_likelihood_ratio
    operator+= semantics, log_likelihood_ratio.cpp:40-73):

    - a == -b               -> 0 (covers +inf + -inf)
    - either operand ±127   -> that infinity (sign preserved)
    - otherwise             -> sum saturated to ±LLR_MAX (±120)

    Preserving the ±127 infinity marks matters: filler positions carry
    +127 ("known zero") and must stay +127 through every retransmission,
    bit-exact with the reference rx buffer."""
    a = old.astype(jnp.int16)
    b = new.astype(jnp.int16)
    sat = jnp.clip(a + b, -LLR_MAX, LLR_MAX)
    inf_a = jnp.abs(a) == LLR_INF
    inf_b = jnp.abs(b) == LLR_INF
    s = jnp.where(inf_a, a, jnp.where(inf_b, b, sat))
    s = jnp.where(a == -b, 0, s)
    return s.astype(jnp.int8)
