"""Transport-block segmentation for LDPC-coded SCH (TS 38.212 §5.2.2).

Counterpart of the reference's ldpc_segmenter_tx/rx
(lib/phy/upper/channel_coding/ldpc/ldpc_segmenter_tx_impl.cpp) and the
derived-parameter helper lib/ran/sch/sch_segmentation.cpp — re-designed so
that all segmentation geometry is a static host-side description
(`SegmentParams`) and the per-bit work (CRC attach, filler insertion) is a
batched jitted routine.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import crc as crc_mod
from . import graphs

# Maximum codeblock payload per base graph (TS 38.212 §5.2.2).
MAX_SEG_BITS = {graphs.BG1: 8448, graphs.BG2: 3840}
CB_CRC_BITS = 24


def tb_crc_name(tbs: int) -> str:
    """TB-level CRC: 24A above 3824 bits, else 16 (TS 38.212 §7.2.1)."""
    return "24A" if tbs > 3824 else "16"


@dataclasses.dataclass(frozen=True)
class SegmentParams:
    """Static segmentation geometry for one transport block configuration."""

    tbs: int  # A: TB payload bits (no CRC)
    base_graph: int
    nof_codeblocks: int  # C
    lifting_size: int  # Z
    nof_cb_bits: int  # K = K_b * Z (message length fed to the encoder)
    nof_payload_bits_per_cb: int  # K': info+CRC bits per codeblock
    nof_filler_bits: int  # F = K - K'
    zero_pad: int  # zeros appended after the TB CRC in the last segment (TS 38.212 ceil split)
    tb_crc: str

    @property
    def full_codeword_bits(self) -> int:
        g = graphs.get_graph(self.base_graph, self.lifting_size)
        return g.nof_codeword_bits  # N = 66Z / 50Z


def compute_segment_params(tbs: int, target_code_rate: float) -> SegmentParams:
    bg = graphs.select_base_graph(tbs, target_code_rate)
    return compute_segment_params_bg(tbs, bg)


def compute_segment_params_bg(tbs: int, base_graph: int) -> SegmentParams:
    """Segmentation geometry for an explicitly selected base graph
    (reference: segmenter_config carries the base graph directly)."""
    bg = base_graph
    crc_name = tb_crc_name(tbs)
    l_tb = crc_mod.POLYS[crc_name][1]
    b = tbs + l_tb
    k_cb = MAX_SEG_BITS[bg]
    if b <= k_cb:
        c = 1
    else:
        c = -(-b // (k_cb - CB_CRC_BITS))
    # B' = B + C*24 (C > 1); K' = ceil(B'/C); the shortfall of the ceil split
    # is zero-padded after the TB CRC in the last segment
    # (reference: ldpc_segmenter_tx_impl.cpp:85-90,189).
    b_prime = b + (CB_CRC_BITS * c if c > 1 else 0)
    k_prime = -(-b_prime // c)
    zero_pad = k_prime * c - b_prime
    z = graphs.select_lifting_size(bg, b, c)
    g = graphs.get_graph(bg, z)
    k = g.kb * z
    return SegmentParams(
        tbs=tbs,
        base_graph=bg,
        nof_codeblocks=c,
        lifting_size=z,
        nof_cb_bits=k,
        nof_payload_bits_per_cb=k_prime,
        nof_filler_bits=k - k_prime,
        zero_pad=zero_pad,
        tb_crc=crc_name,
    )


def rate_matched_length(
    params: SegmentParams, cb_index: int, qm: int, nof_layers: int, nof_ch_symbols: int
) -> int:
    """Rate-matched length E_j of segment `cb_index` (TS 38.212 §5.4.2.1;
    reference: ldpc_segmenter_helpers.h compute_rm_length).

    `nof_ch_symbols` counts channel symbols over all layers (the reference
    segmenter_config convention); symbols per layer = nof_ch_symbols / N_L.
    """
    c = params.nof_codeblocks
    symbols_per_layer = nof_ch_symbols // nof_layers
    nof_short = c - (symbols_per_layer % c)
    if cb_index < nof_short:
        tmp = symbols_per_layer // c
    else:
        tmp = -(-symbols_per_layer // c)
    return tmp * nof_layers * qm


def segment_tx(tb_bits: jax.Array, params: SegmentParams) -> jax.Array:
    """TB payload bits (..., A) -> (..., C, K) encoder-ready codeblocks.

    Appends the TB CRC, splits into C equal segments, appends a CRC24B per
    segment when C > 1, and zero-fills the F filler positions (the rate
    matcher skips them by index).
    """
    with_crc = crc_mod.crc_append(tb_bits, params.tb_crc)
    if params.zero_pad:
        zp = jnp.zeros(with_crc.shape[:-1] + (params.zero_pad,), dtype=with_crc.dtype)
        with_crc = jnp.concatenate([with_crc, zp], axis=-1)
    c = params.nof_codeblocks
    seg_payload = with_crc.shape[-1] // c
    segs = with_crc.reshape(with_crc.shape[:-1] + (c, seg_payload))
    if c > 1:
        segs = crc_mod.crc_append(segs, "24B")
    fill = jnp.zeros(segs.shape[:-1] + (params.nof_filler_bits,), dtype=jnp.uint8)
    return jnp.concatenate([segs.astype(jnp.uint8), fill], axis=-1)


def desegment_rx(cb_bits: jax.Array, params: SegmentParams):
    """(..., C, K) decoded codeblock bits -> ((..., A) TB payload, ok mask).

    Checks per-CB CRCs (when segmented) and the TB CRC; returns the payload
    and a boolean per-TB success flag.
    """
    from ...support.staging import checkpoint

    c = params.nof_codeblocks
    k_prime = params.nof_payload_bits_per_cb
    payload = cb_bits[..., :k_prime]
    # Accumulate failures as integer counts.
    nof_bad = jnp.zeros(cb_bits.shape[:-2], jnp.int32)
    if c > 1:
        cb_crc = checkpoint(crc_mod.crc(payload, "24B")).astype(jnp.int32)
        nof_bad = nof_bad + cb_crc.sum(axis=(-2, -1))
        payload = payload[..., : k_prime - CB_CRC_BITS]
        # TB CRC verdict straight from the per-CB payload chunks (two
        # matmuls, no megabit chunk pipeline); trailing zero_pad in the
        # stream leaves the verdict unchanged (crc_check_concat doc).
        tb_bad = ~checkpoint(crc_mod.crc_check_concat(payload, params.tb_crc))
        nof_bad = nof_bad + tb_bad.astype(jnp.int32)
        tb_with_crc = payload.reshape(payload.shape[:-2] + (-1,))
        if params.zero_pad:
            tb_with_crc = tb_with_crc[..., : tb_with_crc.shape[-1] - params.zero_pad]
    else:
        tb_with_crc = payload.reshape(payload.shape[:-2] + (-1,))
        if params.zero_pad:
            tb_with_crc = tb_with_crc[..., : tb_with_crc.shape[-1] - params.zero_pad]
        tb_crc = checkpoint(crc_mod.crc(tb_with_crc, params.tb_crc)).astype(jnp.int32)
        nof_bad = nof_bad + tb_crc.sum(axis=-1)
    tb_ok = checkpoint(nof_bad == 0)
    l_tb = crc_mod.POLYS[params.tb_crc][1]
    return tb_with_crc[..., : tb_with_crc.shape[-1] - l_tb], tb_ok
