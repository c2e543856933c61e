"""CRC calculators for 5G NR (TS 38.212 §5.1).

Counterpart of the reference's crc_calculator_{lut,clmul,neon}_impl
(lib/phy/upper/channel_coding/crc_calculator_lut_impl.cpp) — re-designed as
linear algebra: a CRC over GF(2) is a linear map of the message bits, so for a fixed
message length L the checksum is ``(bits @ A) mod 2`` where ``A`` is an
(L, crc_len) 0/1 matrix whose row i is the CRC of the i-th unit vector.
That matmul runs in f32 (exact for L < 2^24, TF32 included) and batches over
codeblocks for free.  The generator matrices are cached per (poly, L).

A pure-Python long-division model (`crc_ref`) is the test oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Generator polynomials, including the leading x^len term (TS 38.212 §5.1).
POLY_CRC24A = (0x1864CFB, 24)
POLY_CRC24B = (0x1800063, 24)
POLY_CRC24C = (0x1B2B117, 24)
POLY_CRC16 = (0x11021, 16)
POLY_CRC11 = (0xE21, 11)
POLY_CRC6 = (0x61, 6)

POLYS = {
    "24A": POLY_CRC24A,
    "24B": POLY_CRC24B,
    "24C": POLY_CRC24C,
    "16": POLY_CRC16,
    "11": POLY_CRC11,
    "6": POLY_CRC6,
}


def crc_ref(bits, name: str) -> np.ndarray:
    """Bit-exact long-division CRC (spec model / oracle).

    bits: 1-D array-like of 0/1, MSB-first message.
    Returns the crc as a 0/1 uint8 array of length crc_len, MSB first.
    """
    poly, n = POLYS[name]
    reg = 0
    for b in np.asarray(bits, dtype=np.uint8):
        reg = (reg << 1) | int(b)
        if reg >> n:
            reg ^= poly
    # Flush n zero bits.
    for _ in range(n):
        reg <<= 1
        if reg >> n:
            reg ^= poly
    return np.array([(reg >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _generator_matrix(name: str, length: int) -> np.ndarray:
    """(length, crc_len) uint8 matrix A with A[i] = crc(e_i).

    Built by stepping x^(crc_len + k) mod g(x) from k = 0 upwards: the last
    message bit contributes x^crc_len mod g, the one before x^(crc_len+1),
    etc.
    """
    poly, n = POLYS[name]
    mask = (1 << n) - 1
    out = np.empty((length, n), dtype=np.uint8)
    r = 1  # x^0
    # Advance to x^n mod g.
    for _ in range(n):
        r <<= 1
        if r >> n:
            r ^= poly
    for k in range(length):
        row = length - 1 - k
        out[row] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
        r <<= 1
        if r >> n:
            r ^= poly
    return out


def generator_matrix(name: str, length: int) -> np.ndarray:
    return _generator_matrix(name, length)


# Chunk width for the hierarchical CRC: one small (CHUNK, crc_len) matrix
# plus log2(K) tiny (crc_len, crc_len) advance matrices — no O(L) constants
# baked into the compiled program (a 1 Mbit TB would otherwise embed a
# ~100 MB generator matrix in the HLO).
_CHUNK = 1024


@functools.lru_cache(maxsize=None)
def _advance_matrix(name: str, nof_bits: int) -> np.ndarray:
    """(n, n) GF(2) matrix advancing a CRC state by nof_bits zero bits:
    row b = (x^{n-1-b} * x^{nof_bits}) mod g as an n-bit MSB-first vector.

    Built by squaring: T_{2s} = T_s T_s (nof_bits here is always
    _CHUNK * 2^j, so the recursion grounds at _CHUNK).
    """
    poly, n = POLYS[name]
    if nof_bits > _CHUNK:
        assert nof_bits % 2 == 0
        t = _advance_matrix(name, nof_bits // 2)
        return (t.astype(np.int64) @ t.astype(np.int64) % 2).astype(np.uint8)
    out = np.empty((n, n), dtype=np.uint8)
    for b in range(n):
        r = 1 << (n - 1 - b)
        for _ in range(nof_bits):
            r <<= 1
            if r >> n:
                r ^= poly
        out[b] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
    return out


@functools.lru_cache(maxsize=None)
def _fold_matrix(name: str, nof_chunks: int) -> np.ndarray:
    """(nof_chunks * n, n) GF(2) fold matrix: row block j is the advance
    matrix T_{(nof_chunks-1-j)*_CHUNK} — chunk j's partial CRC, advanced by
    the number of message bits that FOLLOW it, contributes linearly to the
    final CRC.  One matmul replaces the log-depth pairwise fold tree (the
    tree was ~12 levels of tiny ops at 1 Mbit TBs and dominated the
    measured desegment cost)."""
    poly, n = POLYS[name]
    t_chunk = _advance_matrix(name, _CHUNK).astype(np.int64)
    out = np.empty((nof_chunks, n, n), dtype=np.uint8)
    cur = np.eye(n, dtype=np.int64)
    for j in range(nof_chunks):
        out[nof_chunks - 1 - j] = cur.astype(np.uint8)
        cur = (cur @ t_chunk) % 2
    return out.reshape(nof_chunks * n, n)


# Messages at or below this length take the DIRECT path: one (L, n)
# matmul with the plain generator matrix as the program constant (a
# codeblock-sized constant is ~800 KB — cheap; the chunked path exists
# for megabit TBs whose full generator matrix would be ~100 MB of HLO).
_DIRECT_MAX = 16384


@functools.partial(jax.jit, static_argnames=("name",))
def crc(bits: jax.Array, name: str) -> jax.Array:
    """CRC of messages as matmuls, compile-light.

    bits: (..., L) 0/1 array.  Returns (..., crc_len) uint8, MSB first.

    Codeblock-scale messages (L <= 16384): ONE (L, n) generator matmul.
    Larger: front-pad with zeros (leading zeros do not change a CRC) to a
    whole number of _CHUNK-bit chunks; per-chunk partial CRCs are one
    (CHUNK, n) matmul; ONE (K*n, n) fold matmul combines every chunk's
    contribution (CRC is linear over GF(2), so each chunk's partial CRC
    advanced by its tail length adds into the final value).  All matmuls
    are exact: 0/1 inputs are exact in bf16 or TF32 products and the f32
    accumulator holds integer counts < 2^24; counts reduce mod 2.
    """
    length = bits.shape[-1]
    n = POLYS[name][1]
    if length <= _DIRECT_MAX:
        a = jnp.asarray(generator_matrix(name, length), dtype=jnp.float32)
        out = jnp.matmul(bits.astype(jnp.float32), a,
                         preferred_element_type=jnp.float32)
        return (out.astype(jnp.int32) & 1).astype(jnp.uint8)
    k = max(1, -(-length // _CHUNK))
    pad = k * _CHUNK - length
    x = jnp.pad(bits.astype(jnp.float32), [(0, 0)] * (bits.ndim - 1) + [(pad, 0)])
    x = x.reshape(x.shape[:-1] + (k, _CHUNK))
    a = jnp.asarray(generator_matrix(name, _CHUNK), dtype=jnp.float32)
    part = jnp.matmul(x, a, preferred_element_type=jnp.float32)
    part = (part.astype(jnp.int32) & 1).astype(jnp.float32)  # (..., K, n)
    if k == 1:
        return part[..., 0, :].astype(jnp.int32).astype(jnp.uint8)
    m = jnp.asarray(_fold_matrix(name, k), dtype=jnp.float32)
    flat = part.reshape(part.shape[:-2] + (k * n,))
    comb = jnp.matmul(flat, m, preferred_element_type=jnp.float32)
    return (comb.astype(jnp.int32) & 1).astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _span_advance_matrix(name: str, nof_bits: int) -> np.ndarray:
    """(n, n) GF(2) advance matrix for an ARBITRARY span (binary-power
    composition of the squaring chain)."""
    poly, n = POLYS[name]
    base = np.eye(n, dtype=np.int64)
    # T_1 by direct construction.
    t1 = np.empty((n, n), dtype=np.int64)
    for b in range(n):
        r = 1 << (n - 1 - b)
        r <<= 1
        if r >> n:
            r ^= poly
        t1[b] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
    acc = base
    p = t1
    s = nof_bits
    while s:
        if s & 1:
            acc = (acc @ p) % 2
        p = (p @ p) % 2
        s >>= 1
    return acc.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _concat_fold_matrix(name: str, nof_chunks: int, chunk_bits: int) -> np.ndarray:
    """(nof_chunks * n, n) fold matrix for equal chunk_bits-long chunks."""
    poly, n = POLYS[name]
    t = _span_advance_matrix(name, chunk_bits).astype(np.int64)
    out = np.empty((nof_chunks, n, n), dtype=np.uint8)
    cur = np.eye(n, dtype=np.int64)
    for j in range(nof_chunks):
        out[nof_chunks - 1 - j] = cur.astype(np.uint8)
        cur = (cur @ t) % 2
    return out.reshape(nof_chunks * n, n)


@functools.partial(jax.jit, static_argnames=("name",))
def crc_check_concat(chunks: jax.Array, name: str) -> jax.Array:
    """CRC pass/fail of the CONCATENATION of equal-length chunks without
    materializing the concatenated stream: per-chunk partial CRCs (one
    generator matmul) fold with per-position advance matrices (one fold
    matmul).  chunks: (..., C, L) 0/1; returns (...,) bool.

    The megabit TB CRC check collapses to two matmuls this way — the
    desegment stage computes it straight from the (C, K') codeblock
    payloads (trailing zero padding in the stream does not change the
    verdict: the advance matrix is invertible over GF(2), so
    crc(S || 0^z) = T_z crc(S) = 0 iff crc(S) = 0).
    """
    c, length = chunks.shape[-2], chunks.shape[-1]
    n = POLYS[name][1]
    a = jnp.asarray(generator_matrix(name, length), dtype=jnp.float32)
    part = jnp.matmul(chunks.astype(jnp.float32), a,
                      preferred_element_type=jnp.float32)
    part = (part.astype(jnp.int32) & 1).astype(jnp.float32)  # (..., C, n)
    m = jnp.asarray(_concat_fold_matrix(name, c, length), dtype=jnp.float32)
    comb = jnp.matmul(part.reshape(part.shape[:-2] + (c * n,)), m,
                      preferred_element_type=jnp.float32)
    return (comb.astype(jnp.int32) & 1).sum(axis=-1) == 0


def crc_append(bits: jax.Array, name: str) -> jax.Array:
    """Message with CRC attached: (..., L) -> (..., L + crc_len)."""
    c = crc(bits, name)
    return jnp.concatenate([bits.astype(jnp.uint8), c], axis=-1)


def crc_check(bits_with_crc: jax.Array, name: str) -> jax.Array:
    """Boolean per-message CRC pass/fail for (..., L + crc_len) inputs."""
    c = crc(bits_with_crc, name)
    return jnp.all(c == 0, axis=-1)
