"""Numeric kernels for the NR PHY, written accelerator-first (jnp).

Each module pairs a bit-exact "spec model" (NumPy, used as the test oracle)
with a jittable fast path of batched tensor ops: GF(2) algebra becomes
f32 matmuls mod 2, LFSRs become precomputed linear maps, SIMD dispatch
becomes XLA.
"""
