"""Gold-sequence pseudo-random generator and scrambling (TS 38.211 §5.2.1).

Counterpart of the reference's pseudo_random_generator_impl
(lib/phy/upper/sequence_generators/pseudo_random_generator_impl.cpp) with its
x1/x2 LFSRs and fast-advance — re-designed as a *linear-algebra*
generator with only tiny constants (31x31 GF(2) matrices), so arbitrarily
long sequences compile to small HLO:

An LFSR state s_t = (x(t) .. x(t+30)) advances 31 steps by a constant
matrix M: s_{t+31} = s_t M over GF(2).  The 31-bit outputs of block k ARE
the state s_{31k}, so the whole sequence is the row-concatenation of block
states — and all block states are produced in log2(K) doubling steps:
states[2^j .. 2^{j+1}) = states[0 .. 2^j) @ M^{2^j}.  Matmuls run in f32
(exact, TF32 included: 0/1 operands, sums <= 31) and the seed may be a traced value (per-UE
RNTIs under jit).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NC = 1600
_NBITS = 31

_X1_TAPS = (0, 3)
_X2_TAPS = (0, 1, 2, 3)


def _lfsr_step_block(state: np.ndarray, taps) -> np.ndarray:
    """Advance a (…, 31) LFSR window by 31 outputs (NumPy, for matrices)."""
    x = np.concatenate([state, np.zeros(state.shape[:-1] + (_NBITS,), np.uint8)], axis=-1)
    for i in range(_NBITS):
        acc = x[..., i + taps[0]]
        for t in taps[1:]:
            acc = acc ^ x[..., i + t]
        x[..., _NBITS + i] = acc
    return x[..., _NBITS:]


@functools.lru_cache(maxsize=None)
def _adv31_matrix(taps) -> np.ndarray:
    """M (31, 31) with s_{t+31} = s_t @ M over GF(2)."""
    eye = np.eye(_NBITS, dtype=np.uint8)
    return _lfsr_step_block(eye, taps)


@functools.lru_cache(maxsize=None)
def _adv31_power(taps, j: int) -> np.ndarray:
    """M^(2^j) by repeated squaring (host, exact int)."""
    if j == 0:
        return _adv31_matrix(taps)
    t = _adv31_power(taps, j - 1).astype(np.int64)
    return ((t @ t) % 2).astype(np.uint8)


def _block_states(seed: jax.Array, taps, nof_blocks: int) -> jax.Array:
    """(…, K, 31) block states from a traced (…, 31) seed by doubling."""
    s = seed.astype(jnp.float32)[..., None, :]  # (…, 1, 31)
    j = 0
    while s.shape[-2] < nof_blocks:
        m = jnp.asarray(_adv31_power(taps, j), jnp.float32)
        nxt = jnp.matmul(s, m, preferred_element_type=jnp.float32)
        nxt = (nxt.astype(jnp.int32) & 1).astype(jnp.float32)
        s = jnp.concatenate([s, nxt], axis=-2)
        if s.shape[-2] > nof_blocks:
            s = s[..., :nof_blocks, :]
        j += 1
    return s


def gold_ref(c_init: int, length: int) -> np.ndarray:
    """Direct LFSR spec model (oracle): c(n) for n in [0, length)."""
    total = NC + length
    x1 = np.zeros(total + _NBITS, dtype=np.uint8)
    x2 = np.zeros(total + _NBITS, dtype=np.uint8)
    x1[0] = 1
    for i in range(_NBITS):
        x2[i] = (c_init >> i) & 1
    for i in range(total):
        x1[i + _NBITS] = x1[i + 3] ^ x1[i]
        x2[i + _NBITS] = x2[i + 3] ^ x2[i + 2] ^ x2[i + 1] ^ x2[i]
    return x1[NC : NC + length] ^ x2[NC : NC + length]


@functools.partial(jax.jit, static_argnames=("length",))
def gold_sequence(c_init: jax.Array, length: int) -> jax.Array:
    """Gold sequence c(n), n in [0, length), with traced c_init.

    c_init: scalar or batched (...,) uint32 seed.
    Returns (..., length) uint8 bits.

    The x2 block states come from a TWO-LEVEL matmul decomposition
    (j = a*T + b => s_j = seed @ (M^31T)^a @ (M^31)^b): two matmuls
    against small host constants produce every state in one pass, where
    the earlier log2(K)-step doubling rewrote the growing state array ~19
    times (~400 MB of memory traffic per 10 Mbit codeword).  x1's seed is
    fixed, so its bits are a baked host constant."""
    total = NC + length
    k = -(-total // _NBITS)
    c_init = jnp.asarray(c_init, dtype=jnp.uint32)
    batch = c_init.shape

    seed2 = ((c_init[..., None] >> jnp.arange(_NBITS, dtype=jnp.uint32)) & 1).astype(jnp.float32)
    cmat, dmat, t_blk = _two_level_mats(_X2_TAPS, k)
    nof_a = dmat.shape[0]
    # s1[a] = seed @ D_a ; states[a, b] = s1[a] @ C_b   (exact in f32:
    # every dot is a sum of <= 31 bit products).  Both banks are flattened
    # to (31, K*31) so each level is ONE matmul rather than a batched einsum of
    # hundreds of tiny 31x31 matmuls.
    dflat = jnp.asarray(dmat.transpose(1, 0, 2).reshape(_NBITS, -1))
    s_a = jnp.matmul(seed2, dflat, preferred_element_type=jnp.float32)
    s_a = (s_a.astype(jnp.int32) & 1).astype(jnp.float32)
    s_a = s_a.reshape(batch + (nof_a, _NBITS))
    cflat = jnp.asarray(cmat.transpose(1, 0, 2).reshape(_NBITS, -1))
    states = jnp.matmul(s_a, cflat, preferred_element_type=jnp.float32)
    states = (states.astype(jnp.int32) & 1).astype(jnp.uint8)
    x2 = states.reshape(batch + (nof_a * t_blk * _NBITS,))[..., NC : NC + length]

    x1 = jnp.asarray(_x1_bits(length))
    return x1 ^ x2


@functools.lru_cache(maxsize=None)
def _two_level_mats(taps, k: int):
    """(C (T,31,31), D (ceil(k/T),31,31), T) f32 advance-matrix banks for
    the two-level state generation covering >= k blocks."""
    t_blk = 1 << max(0, (max(k, 1) - 1).bit_length() // 2)
    nof_a = -(-k // t_blk)
    m31 = _adv31_matrix(taps).astype(np.int64)
    c = np.empty((t_blk, _NBITS, _NBITS), np.float32)
    cur = np.eye(_NBITS, dtype=np.int64)
    for b in range(t_blk):
        c[b] = cur
        cur = (cur @ m31) % 2
    m31t = cur  # M^(31*T)
    d = np.empty((nof_a, _NBITS, _NBITS), np.float32)
    cur = np.eye(_NBITS, dtype=np.int64)
    for a in range(nof_a):
        d[a] = cur
        cur = (cur @ m31t) % 2
    return c, d, t_blk


@functools.lru_cache(maxsize=None)
def _x1_bits(length: int) -> np.ndarray:
    """x1 output bits (seed fixed by TS 38.211): host-precomputed LFSR."""
    total = NC + length
    x1 = np.zeros(total + _NBITS, dtype=np.uint8)
    x1[0] = 1
    for i in range(total):
        x1[i + _NBITS] = x1[i + 3] ^ x1[i]
    return x1[NC : NC + length]


def scramble_bits(bits: jax.Array, c_init: jax.Array) -> jax.Array:
    """Scramble a (..., N) bit array (XOR with the Gold sequence)."""
    seq = gold_sequence(c_init, bits.shape[-1])
    return (bits.astype(jnp.uint8) ^ seq).astype(jnp.uint8)


def descramble_llrs(llrs: jax.Array, c_init: jax.Array) -> jax.Array:
    """Descramble int8 LLRs by sign-flipping where the sequence bit is 1.

    Matches the reference demodulator's descrambling-by-sign-flip
    (lib/phy/upper/channel_processors/pusch/pusch_demodulator_impl.cpp:282).
    Flip of -128 saturates to +127 to stay in int8.
    """
    seq = gold_sequence(c_init, llrs.shape[-1])
    flipped = jnp.where(
        llrs == jnp.int8(-128), jnp.int8(127), (-llrs.astype(jnp.int16)).astype(jnp.int8)
    )
    return jnp.where(seq == 1, flipped, llrs)
