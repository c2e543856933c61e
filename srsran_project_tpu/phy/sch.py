"""Shared-channel transport coding: TB bits <-> codeword bits/LLRs.

The common core of the PDSCH encoder chain (reference:
pdsch_processor_impl.cpp:42 — CRC -> LDPC segment/encode -> rate match) and
the PUSCH decoder chain (pusch_decoder_impl.cpp — rate dematch -> HARQ
combine -> LDPC decode -> CRC), with the per-codeblock E_r split of
TS 38.212 §5.4.2.1.  All geometry is static per `SchConfig`; codeblocks
batch along a leading axis on device.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops.ldpc import decoder as ldpc_decoder
from ..ops.ldpc import decoder_cuda as ldpc_decoder_cuda
from ..ops.ldpc import encoder as ldpc_encoder
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc import segmenter
from ..ops import crc as crc_mod
from ..support import platform
from ..support.staging import checkpoint


@dataclasses.dataclass(frozen=True)
class SchConfig:
    """Static transport-block coding configuration."""

    tbs: int
    target_code_rate: float  # R (for BG/segmentation selection)
    qm: int  # modulation order
    nof_layers: int
    nof_total_bits: int  # G: total rate-matched bits for this codeword
    rv: int = 0
    # TBS_LBRM for limited-buffer rate matching (TS 38.212 5.4.2.1);
    # the reference default (sch_constants.h:44).  None = unlimited buffer.
    tbs_lbrm_bytes: int | None = 159749
    # LDPC decoder: "auto" = the backend's choice (support/platform.py:
    # the Hopper kernel on the GPU, the XLA float min-sum elsewhere);
    # "reference_i8" = bit-exact int8 layered min-sum with the reference's
    # saturation semantics (ldpc_decoder_generic.cpp — conformance /
    # parity-debug path).
    decoder: str = "auto"

    @functools.cached_property
    def seg(self) -> segmenter.SegmentParams:
        return segmenter.compute_segment_params(self.tbs, self.target_code_rate)

    @functools.cached_property
    def n_cb(self) -> int | None:
        """Circular-buffer length min(N, N_ref); None = full N (so the
        rate matcher's default path stays untouched when unlimited)."""
        if self.tbs_lbrm_bytes is None:
            return None
        n = self.seg.full_codeword_bits
        n_ref = min(self.tbs_lbrm_bytes * 8 * 3 // (2 * self.seg.nof_codeblocks),
                    25344)  # ldpc::MAX_CODEBLOCK_SIZE
        return n_ref if n_ref < n else None

    @functools.cached_property
    def cb_e_bits(self) -> tuple[int, ...]:
        """Per-codeblock rate-matched length E_r (TS 38.212 §5.4.2.1)."""
        c = self.seg.nof_codeblocks
        g = self.nof_total_bits
        unit = self.qm * self.nof_layers
        assert g % unit == 0, (g, unit)
        lo = unit * (g // (unit * c))
        hi = lo + unit
        nof_hi = (g // unit) % c
        return tuple([lo] * (c - nof_hi) + [hi] * nof_hi)


def _e_groups(cb_e_bits):
    """Codeblocks grouped by equal E: [(start, count, e)], contiguous
    (TS 38.212 puts all low-E blocks first)."""
    groups = []
    start = 0
    for e in cb_e_bits:
        if groups and groups[-1][2] == e:
            s, c, _ = groups[-1]
            groups[-1] = (s, c + 1, e)
        else:
            groups.append((start, 1, e))
        start += 1
    return groups


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_transport_block(tb_bits: jax.Array, cfg: SchConfig) -> jax.Array:
    """TB payload (..., A) -> codeword bits (..., G).

    One compiled program (segment + CRC + LDPC encode + rate match), so no
    eager glue dispatches between the sub-blocks."""
    seg = cfg.seg
    cbs = segmenter.segment_tx(tb_bits, seg)  # (..., C, K)
    buf = ldpc_encoder.encode_to_buffer(cbs, seg.base_graph, seg.lifting_size,
                                        n_cb=cfg.n_cb)
    k_prime = seg.nof_payload_bits_per_cb
    pieces = []
    for start, count, e in _e_groups(cfg.cb_e_bits):
        grp = rm.rate_match(
            buf[..., start : start + count, :],
            seg.base_graph,
            seg.lifting_size,
            k_prime,
            e,
            cfg.rv,
            cfg.qm,
            cfg.n_cb,
        )  # (..., count, e)
        pieces.append(grp.reshape(grp.shape[:-2] + (count * e,)))
    return jnp.concatenate(pieces, axis=-1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _dematch_stage(llrs: jax.Array, harq_buffer, cfg: SchConfig):
    """Rate dematch + HARQ combine, one compiled program.

    harq_buffer may be None (its None-ness is pytree structure, so the two
    cases compile separately).  Returns the codeword buffer (..., C, N)
    int8: the new HARQ state and the decoder input."""
    seg = cfg.seg
    k_prime = seg.nof_payload_bits_per_cb
    dematched = []
    off = 0
    for start, count, e in _e_groups(cfg.cb_e_bits):
        span = llrs[..., off : off + count * e]
        span = span.reshape(span.shape[:-1] + (count, e))
        dematched.append(
            rm.rate_dematch(
                span, seg.base_graph, seg.lifting_size, k_prime, e, cfg.rv, cfg.qm,
                cfg.n_cb,
            )
        )
        off += count * e
    buf = jnp.concatenate(dematched, axis=-2)  # (..., C, N)
    if harq_buffer is not None:
        buf = rm.combine_harq(harq_buffer, buf)
    return buf


@functools.partial(jax.jit, static_argnames=("cfg", "lead_shape"))
def _desegment_stage(bits: jax.Array, cfg: SchConfig, lead_shape: tuple):
    """CB reshape + TB desegmentation + CRC verdict, one compiled program."""
    seg = cfg.seg
    bits = bits.reshape(lead_shape + (seg.nof_codeblocks, bits.shape[-1]))
    return segmenter.desegment_rx(bits, seg)


def decode_transport_block(
    llrs: jax.Array,
    cfg: SchConfig,
    nof_iterations: int = 6,
    harq_buffer: jax.Array | None = None,
    early_stop: bool = False,
):
    """Codeword LLRs (..., G) int8 -> (tb_bits (..., A), tb_crc_ok (...,),
    new_harq_buffer (..., C, N)).

    harq_buffer holds accumulated codeword-buffer LLRs from earlier
    (re)transmissions; pass None for a new transmission.
    """
    seg = cfg.seg
    new_harq = checkpoint(_dematch_stage(llrs, harq_buffer, cfg))
    buf = new_harq.reshape((-1,) + new_harq.shape[-1:])  # (C', N) int8
    kernel = "reference_i8" if cfg.decoder == "reference_i8" else platform.ldpc_decoder()
    bg, z = seg.base_graph, seg.lifting_size

    def run_decode(iters):
        return ldpc_decoder.decode(buf.astype(jnp.float32), bg, z, iters,
                                   n_cb=cfg.n_cb)[0]

    if kernel == "reference_i8":
        # Keep the integer lanes: decode_i8 applies the reference's own
        # +-64 input clamp (ldpc_decoder_impl.h:205).
        bits = ldpc_decoder.decode_i8(buf.astype(jnp.int32), bg, z,
                                      nof_iterations)[0]
    elif kernel == "cuda":
        # int8 in, hard bits out, early stop per codeblock inside the kernel.
        bits = ldpc_decoder_cuda.decode(buf, bg, z, nof_iterations,
                                        early_stop=early_stop, n_cb=cfg.n_cb)[0]
    elif early_stop and nof_iterations > 2:
        # CRC-gated two-phase decode (the reference's per-iteration CRC
        # early stop, adapted to static shapes): try 2 iterations; only if
        # any codeblock's CRC still fails run the full budget.  At
        # operating SNR most slots take the short path.  NOTE: under vmap
        # the cond lowers to a select (both phases run).
        bits2 = run_decode(2)
        k_prime = seg.nof_payload_bits_per_cb
        crc_name = "24B" if seg.nof_codeblocks > 1 else seg.tb_crc
        nof_bad = crc_mod.crc(bits2[..., :k_prime], crc_name).astype(jnp.int32).sum()
        bits = jax.lax.cond(
            nof_bad == 0, lambda: bits2, lambda: run_decode(nof_iterations)
        )
    else:
        bits = run_decode(nof_iterations)
    checkpoint(bits)
    tb, ok = _desegment_stage(bits, cfg, new_harq.shape[:-2])
    return tb, ok, new_harq
