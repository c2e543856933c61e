"""Sequence-parallel (subcarrier-sharded) PUSCH front end for carriers too
wide for one chip — the north-star's sequence-length scaling axis
(SURVEY.md §5.7).

A wide carrier's resource grid shards along the subcarrier axis over the
mesh; everything per-RE (LS pilot estimate, OCC despread, interpolation,
MMSE equalization, soft demapping) is shard-local, and the ONLY
communication is:

  - the raised-cosine smoothing filter's halo at shard boundaries
    (overlap-save via `jax.lax.ppermute`, +5 CDM pairs each side: 4 for the
    9-tap filter, 1 for the linear interpolation straddling the boundary);
  - one scalar psum for the global noise-variance / SNR accumulators.

Constraints (asserted): full-band type-1 DM-RS allocation starting at RB 0
with no data on DM-RS symbols, local shard width divisible by 12 (so every
shard sees the same pilot geometry and the shard program is uniform).

The output LLR stream is bit-identical in layout to the unsharded
phy.pusch._front_end (symbol-major, subcarrier order, layer x Qm per RE),
so the existing descramble + LDPC decode path consumes it unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.equalizer import equalize
from ..ops.estimator import _rc_filter_taps
from ..ops.modulation import Modulation, demap_soft, quantize_llr
from ..ops import scrambling
from ..ran import dmrs as dmrs_mod
from ..phy.pusch import PuschConfig, _pusch_c_init
from .sharded_estimator import _halo_exchange


def _check_shardable(cfg: PuschConfig, nof_shards: int) -> tuple[int, int]:
    """Shard geometry: (local_sc, pad_sc).

    Carriers whose PRB count does not divide the mesh (273 PRB / 8 devices
    — the flagship; SURVEY §7's pad-to-shardable + mask prescription) are
    zero-PADDED with whole PRBs on the right so every shard runs the same
    uniform-pilot program; the pad lives entirely in the LAST shard and is
    masked out of every estimate/metric (edge-hold extension keeps the
    smoother's band-edge semantics identical to the unsharded estimator;
    reference mask machinery counterpart:
    pusch_demodulator_impl.cpp:286-291)."""
    a = cfg.alloc
    assert a.rb_start == 0 and a.dmrs_config_type == 1, "full-band type-1 only"
    assert a.nof_sc == cfg.nof_grid_sc, "allocation must span the carrier"
    assert a.nof_cdm_groups_without_data == 2, "no data on DM-RS symbols"
    assert not cfg.cfo_compensation and not cfg.ptrs_enabled and cfg.uci is None
    prbs_per_shard = -(-a.rb_count // nof_shards)
    local_sc = prbs_per_shard * 12
    pad_sc = local_sc * nof_shards - cfg.nof_grid_sc
    assert pad_sc < local_sc, (a.rb_count, nof_shards)
    if pad_sc:
        assert cfg.noise_method == "second_difference", (
            "padded sharding masks the second-difference noise stencil only")
    return local_sc, pad_sc


def padded_width(cfg: PuschConfig, nof_shards: int) -> int:
    """Grid width (subcarriers) expected by sharded_front_end on this mesh
    size — nof_grid_sc rounded up to whole PRBs per shard."""
    local_sc, pad_sc = _check_shardable(cfg, nof_shards)
    return local_sc * nof_shards


def pad_grid(grid: jax.Array, cfg: PuschConfig, nof_shards: int) -> jax.Array:
    """Zero-pad (..., nsc) on the right to the shardable width."""
    w = padded_width(cfg, nof_shards)
    pad = w - grid.shape[-1]
    if pad == 0:
        return grid
    return jnp.pad(grid, [(0, 0)] * (grid.ndim - 1) + [(0, pad)])


@functools.lru_cache(maxsize=None)
def _local_geometry(cfg: PuschConfig, local_sc: int):
    """Per-shard constants: pilot gather indices, OCC, interp tables."""
    nsym_d = len(cfg.alloc.dmrs_symbols)
    # Type-1 pilots of CDM group g sit at 4n + 2k' + g: per-PRB pattern.
    ks_loc, wf_loc = dmrs_mod.pilot_subcarriers(1, 0, local_sc // 12, 0)
    n_pairs = len(ks_loc) // 2
    # OCC per layer (port = layer index, v1 convention).
    wf_layers = np.stack([
        dmrs_mod.pilot_subcarriers(1, layer, local_sc // 12, 0)[1]
        for layer in range(cfg.nof_layers)
    ]).astype(np.float32)  # (nl, Np_loc)
    ks_layers = np.stack([
        dmrs_mod.pilot_subcarriers(1, layer, local_sc // 12, 0)[0]
        for layer in range(cfg.nof_layers)
    ]).astype(np.int32)  # (nl, Np_loc)
    # Interp: pair centers extended one pair each side (halo).
    centers = (ks_loc[0::2] + ks_loc[1::2]) / 2.0  # 1, 5, 9, ... (port-0 ref)
    pos = np.concatenate([[centers[0] - 4.0], centers, [centers[-1] + 4.0]])
    x = np.arange(local_sc, dtype=np.float32)
    li = np.clip(np.searchsorted(pos, x, side="right") - 1, 0, len(pos) - 2)
    frac = np.clip((x - pos[li]) / (pos[li + 1] - pos[li]), 0.0, 1.0)
    data_syms = [s for s in range(cfg.alloc.sym_start,
                                  cfg.alloc.sym_start + cfg.alloc.sym_count)
                 if s not in cfg.alloc.dmrs_symbols]
    return (ks_layers, wf_layers, n_pairs, li.astype(np.int32),
            frac.astype(np.float32), tuple(data_syms), nsym_d)


def _beta2(cfg: PuschConfig) -> float:
    """Square of the SCH-to-DMRS amplitude offset: pilot-domain noise ->
    data-RE-domain noise (pilots in _global_pilots are descaled by beta)."""
    return float(dmrs_mod.sch_to_dmrs_beta(cfg.alloc.nof_cdm_groups_without_data) ** 2)


@functools.lru_cache(maxsize=None)
def _global_pilots(cfg: PuschConfig) -> np.ndarray:
    """(nsym_d, Np_global) DM-RS values r(m) (host LFSR; type-1 full band).

    crb_start repoints the Gold-sequence index to the allocation's absolute
    CRB (TS 38.211 reference point CRB0) — windowed general allocations
    (sharded_decode_windowed) re-home compact windows this way."""
    ppb = dmrs_mod.pilots_per_prb(1)
    n_total = cfg.alloc.rb_count * ppb
    n_skip = cfg.alloc.crb_start * ppb
    out = []
    for sym in cfg.alloc.dmrs_symbols:
        c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym,
                                      cfg.dmrs_scrambling_id, cfg.n_scid)
        c = scrambling.gold_ref(int(c_init),
                                2 * (n_skip + n_total)).astype(np.float32)
        c = c[2 * n_skip :]
        out.append(((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2))
    # Divide out the TX-side SCH-to-DMRS boost so the conj-multiply LS is
    # referenced to data-RE amplitude (see pusch._estimate_constants).
    beta = dmrs_mod.sch_to_dmrs_beta(cfg.alloc.nof_cdm_groups_without_data)
    return (np.stack(out) / np.float32(beta)).astype(np.complex64)


def sharded_front_end(grid: jax.Array, cfg: PuschConfig, mesh: Mesh,
                      axis: str = "sp"):
    """grid (npr, nsym, nsc) with the subcarrier axis sharded over `axis`
    -> (llr_pre_descramble (G,) int8 sharded-consistent global array,
        noise_var scalar, snr scalar).

    Pair with finish_decode() (descramble + LDPC) or feed the existing
    decode_transport_block after descrambling.
    """
    nof_shards = mesh.shape[axis]
    local_sc, pad_sc = _check_shardable(cfg, nof_shards)
    if pad_sc and grid.shape[-1] == cfg.nof_grid_sc:
        grid = pad_grid(grid, cfg, nof_shards)
    assert grid.shape[-1] == local_sc * nof_shards, (
        "pad the grid to padded_width() first (pad_grid helper)",
        grid.shape, local_sc * nof_shards)
    (ks_layers, wf_layers, n_pairs, li, frac, data_syms, nsym_d) = (
        _local_geometry(cfg, local_sc))
    nl, npr = cfg.nof_layers, cfg.nof_rx_ports
    qm = int(cfg.modulation) if cfg.modulation != Modulation.PI_2_BPSK else 1
    taps = _rc_filter_taps()
    halo = len(taps) // 2 + 1  # filter halo + one interp pair
    # Pad geometry (last shard only): pairs/subcarriers beyond the real
    # band are edge-held for the smoother and masked from every reduction.
    n_pairs_pad = pad_sc // 4  # 3 pilot pairs per padded PRB (type 1)
    n_real_pairs = n_pairs - n_pairs_pad
    real_sc = local_sc - pad_sc

    pilots_g = jnp.asarray(_global_pilots(cfg))  # (nsym_d, Np_global)
    if pad_sc:
        pilots_g = jnp.concatenate(
            [pilots_g, jnp.ones((nsym_d, pad_sc // 2), pilots_g.dtype)], -1)
    r_sh = pilots_g.reshape(nsym_d, nof_shards, -1)  # shard axis in middle

    def local(g, r_loc):
        # g: (npr, nsym, local_sc); r_loc: (nsym_d, 1, Np_loc)
        idx = jax.lax.axis_index(axis)
        size = jax.lax.axis_size(axis)
        r_loc = r_loc[:, 0]
        ks = jnp.asarray(ks_layers)  # (nl, Np_loc)
        wf = jnp.asarray(wf_layers)  # (nl, Np_loc)
        y_p = g[:, jnp.asarray(cfg.alloc.dmrs_symbols)][:, :, ks]  # (npr, nsym_d, nl, Np)
        y_p = jnp.moveaxis(y_p, 2, 0)  # (nl, npr, nsym_d, Np)
        ls = y_p * jnp.conj(r_loc)[None, None] * wf[:, None, None, :]
        pair = ls.reshape(ls.shape[:-1] + (n_pairs, 2))
        h_pair_sym = pair.mean(axis=-1)  # (nl, npr, nsym_d, n_pairs)
        h_pair = h_pair_sym.mean(axis=-2)  # time avg: (nl, npr, n_pairs)

        jjp = jnp.arange(n_pairs)
        is_last = idx == size - 1
        if pad_sc:
            # Mask of REAL pairs (pad pairs of the last shard excluded) and
            # edge-hold extension of the channel into the pad, so the RC
            # smoother sees exactly the unsharded estimator's band-edge
            # clamp at the true carrier edge.
            pair_valid = jnp.where(is_last,
                                   (jjp < n_real_pairs).astype(jnp.float32),
                                   jnp.ones((n_pairs,), jnp.float32))
            h_pair = jnp.where(pair_valid > 0, h_pair,
                               h_pair[..., n_real_pairs - 1][..., None])
        else:
            pair_valid = jnp.ones((n_pairs,), jnp.float32)

        # Halo exchange + RC smoothing; keep one extra smoothed pair per
        # side for the boundary-straddling interpolation.
        ext = _halo_exchange(h_pair, halo, axis)  # (nl, npr, n+2*halo)

        # Bulk-delay compensation, matching ops/estimator.estimate_channel:
        # a global per-(layer, port) phase slope over adjacent pairs (the
        # cross-shard product comes from the halo; shard 0 has no left
        # neighbour), derotate before smoothing/interpolation, re-rotate
        # exactly at every subcarrier.
        prod = ext[..., halo : halo + n_pairs] * \
            jnp.conj(ext[..., halo - 1 : halo - 1 + n_pairs])
        # Exclude the global left edge AND any product touching a pad pair
        # (edge-held pads give angle-0 products that bias the slope).
        tmask = jnp.where((jnp.arange(n_pairs) == 0) & (idx == 0),
                          0.0, 1.0) * pair_valid
        slope = jnp.angle(jax.lax.psum(
            (prod * tmask).sum(axis=-1), axis))[..., None]  # (nl, npr, 1)
        g_ext = (idx * n_pairs - halo) + jnp.arange(
            n_pairs + 2 * halo, dtype=jnp.float32)
        ext_d = ext * jnp.exp(-1j * slope * g_ext).astype(ext.dtype)

        w = jnp.asarray(taps)
        k = len(taps)
        sm_len = n_pairs + 2  # [-1 .. n] pair positions
        sm = jnp.zeros(h_pair.shape[:-1] + (sm_len,), h_pair.dtype)
        for i in range(k):
            sm = sm + w[i] * ext_d[..., i + 1 - 1: i + 1 - 1 + sm_len]
        # At the global edges the unsharded interp clamps to the first/last
        # smoothed pair; replicate it into the interp halo slot.
        sm = sm.at[..., 0].set(jnp.where(idx == 0, sm[..., 1], sm[..., 0]))
        sm = sm.at[..., -1].set(jnp.where(idx == size - 1, sm[..., -2], sm[..., -1]))

        h = sm[..., jnp.asarray(li)] * (1 - jnp.asarray(frac)) \
            + sm[..., jnp.asarray(li) + 1] * jnp.asarray(frac)  # (nl, npr, local_sc)
        # Re-rotation at the global subcarrier positions (pair centers sit
        # at 1 + 4n for the type-1 port-0 reference, so k_pair = (x-1)/4).
        x_glob = idx * local_sc + jnp.arange(local_sc, dtype=jnp.float32)
        h = h * jnp.exp(1j * slope * ((x_glob - 1.0) / 4.0)).astype(h.dtype)

        # Noise variance / SNR accumulators (global psum mean).
        if cfg.noise_method == "second_difference":
            # Same estimator as the unsharded path (pusch.py
            # noise_by_second_difference): the OCC despread in h_pair has
            # removed the co-CDM layer exactly, and the (1, -2, 1) stencil
            # over neighbouring pairs cancels channel level + slope, so
            # |d2|^2 reads 3 sigma^2 / nsym_d — unbiased for multi-layer
            # CDM-shared configs where the raw pair residual reads
            # |h_other|^2 + sigma^2.  Cross-shard neighbours come from the
            # halo already exchanged for the RC filter; the two global-edge
            # pairs have no physical neighbour and are masked out.  The
            # stencil runs on the BULK-DELAY-DEROTATED pairs (ext_d, same
            # slope the smoother uses) like the unsharded estimator: the
            # (1,-2,1) cancels level+slope but not curvature, which at
            # high delay spread otherwise reads as noise.
            d2 = (ext_d[..., halo - 1: halo - 1 + n_pairs]
                  - 2.0 * ext_d[..., halo: halo + n_pairs]
                  + ext_d[..., halo + 1: halo + 1 + n_pairs])
            jj = jnp.arange(n_pairs)
            # The last VALID pair (n_real_pairs-1 on a padded last shard)
            # has no physical right neighbour; pad pairs are excluded too.
            edge = ((jj == 0) & (idx == 0)) | \
                ((jj >= n_real_pairs - 1) & (idx == size - 1))
            w_valid = jnp.where(edge, 0.0, 1.0)
            nv_num = jax.lax.psum(((jnp.abs(d2) ** 2) * w_valid).sum(), axis)
            nv_den = jax.lax.psum((w_valid.sum() * nl * npr), axis)
            nv_loc = nv_num / jnp.maximum(nv_den, 1.0) * nsym_d / 3.0
            nv = jnp.maximum(nv_loc * _beta2(cfg), 1e-10)
        else:
            h_rep = jnp.repeat(h_pair_sym, 2, axis=-1)
            resid = ls - h_rep
            nv_loc = (jnp.abs(resid) ** 2).mean() * 2.0 * _beta2(cfg)
            nv = jnp.maximum(jax.lax.pmean(nv_loc, axis), 1e-10)
        rsrp_num = jax.lax.psum(
            ((jnp.abs(h_pair_sym) ** 2) * pair_valid).sum(), axis)
        rsrp_den = jax.lax.psum(pair_valid.sum() * nl * npr * nsym_d, axis)
        rsrp = rsrp_num / jnp.maximum(rsrp_den, 1.0)

        # Equalize + demap the local data REs (all sc of data symbols).
        y_d = g[:, jnp.asarray(data_syms)]  # (npr, nsym_data, local_sc)
        nsym_data = len(data_syms)
        y_flat = y_d.reshape(npr, -1)  # sym-major, sc within symbol
        h_d = jnp.moveaxis(h, 0, -1)  # (npr, local_sc, nl)
        h_full = jnp.tile(h_d[:, None], (1, nsym_data, 1, 1)).reshape(npr, -1, nl)
        x_hat, eq_nvar = equalize(jnp.moveaxis(y_flat, 0, -1),
                                  jnp.moveaxis(h_full, 0, 1), nv,
                                  method=cfg.equalizer)
        # SNR metric following cfg.sinr_method like the unsharded chain:
        # decision-directed EVM of the equalized symbols (default), or the
        # pilot-domain rsrp/nv.
        if cfg.sinr_method == "post_equalization":
            from ..ops.modulation.mapper import constellation

            # Decision-directed EVM with pad subcarriers masked (zero-input
            # pad REs equalize to junk that would bias the metric).
            lut = jnp.asarray(constellation(cfg.modulation))
            err2 = jnp.min(jnp.abs(x_hat[..., None] - lut) ** 2, -1)  # (nd, nl)
            if pad_sc:
                sc_valid = jnp.where(
                    is_last, (jnp.arange(local_sc) < real_sc).astype(jnp.float32),
                    jnp.ones((local_sc,), jnp.float32))
            else:
                sc_valid = jnp.ones((local_sc,), jnp.float32)
            w_re = jnp.tile(sc_valid, nsym_data)[:, None]  # (nd, 1)
            e2 = jax.lax.psum((err2 * w_re).sum(), axis) / \
                jax.lax.psum(w_re.sum() * nl, axis)
            snr = 1.0 / jnp.maximum(e2, 1e-12)
        else:
            snr = rsrp / nv
        llr_layers = demap_soft(x_hat.T, eq_nvar.T, cfg.modulation)  # (nl, nd*qm)
        nd = llr_layers.shape[-1] // qm
        llr = jnp.moveaxis(llr_layers.reshape(nl, nd, qm), 0, 1)  # (nd, nl, qm)
        llr_i8 = quantize_llr(llr.reshape(-1), cfg.llr_range_limit)
        # (nsym_data, local_sc * nl * qm): symbol-major so the gathered
        # global array matches the unsharded didx order exactly.
        return llr_i8.reshape(nsym_data, local_sc * nl * qm), nv, snr

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None, axis), P(None, axis, None)),
        out_specs=(P(None, axis), P(), P()),
    )
    llr2d, nv, snr = fn(grid, r_sh)
    if pad_sc:
        # Pad REs sit at the tail of every symbol row (the last shard's
        # padded PRBs): slice them off so the LLR stream is bit-identical
        # in layout to the unsharded front end.
        llr2d = llr2d[:, : cfg.nof_grid_sc * nl * qm]
    return llr2d.reshape(-1), nv, snr


def sharded_decode_windowed(grid: jax.Array, rnti, cfg: PuschConfig,
                            mesh: Mesh, axis: str = "sp", **kw):
    """General-allocation sharded decode: a PARTIAL-band allocation
    (rb_start > 0 and/or rb_count < carrier) is sliced out of the full
    grid and re-homed as a compact full-band window config — crb_start
    keeps the absolute-CRB pilot/Gold indexing — then runs the padded
    sharded path (the reference handles arbitrary allocations through
    its RE-mask machinery, pusch_demodulator_impl.cpp:286-291; here the
    window slice plus pad-to-shardable+mask cover the same space)."""
    import dataclasses

    a = cfg.alloc
    if a.rb_start == 0 and a.nof_sc == cfg.nof_grid_sc:
        return sharded_decode(grid, rnti, cfg, mesh, axis=axis, **kw)
    window = grid[..., a.sc_start : a.sc_start + a.nof_sc]
    cfg_w = dataclasses.replace(
        cfg,
        alloc=dataclasses.replace(a, rb_start=0,
                                  crb_start=a.crb_start + a.rb_start),
        nof_grid_sc=a.nof_sc)
    return sharded_decode(window, rnti, cfg_w, mesh, axis=axis, **kw)


def sharded_decode(grid: jax.Array, rnti, cfg: PuschConfig, mesh: Mesh,
                   axis: str = "sp", sharded_ldpc: bool = False,
                   decode_axis: str | tuple[str, ...] | None = None):
    """Full sp-sharded PUSCH decode: sharded front end -> descramble ->
    LDPC decode (optionally codeblock-sharded over ``decode_axis``, which
    defaults to the front end's subcarrier axis; pass a tuple like
    ("sp", "dp") on a 2-D mesh to spread codeblocks over every device —
    the sp x dp composition of the two parallel axes)."""
    from ..phy.sch import decode_transport_block

    llr, nv, snr = sharded_front_end(grid, cfg, mesh, axis)
    llr = scrambling.descramble_llrs(llr, _pusch_c_init(jnp.asarray(rnti), cfg.n_id))
    if sharded_ldpc:
        from . import sharded_decode as sd
        from ..phy.sch import _dematch_stage, _desegment_stage

        if decode_axis is None:
            decode_axis = axis
        nof_shards = (int(np.prod([mesh.shape[a] for a in decode_axis]))
                      if isinstance(decode_axis, tuple) else mesh.shape[decode_axis])
        seg = cfg.sch.seg
        buf = _dematch_stage(llr, None, cfg.sch)  # (C, N) int8
        c = buf.shape[0]
        pad = (-c) % nof_shards
        buf_p = jax.device_put(
            jnp.pad(buf, ((0, pad), (0, 0))),
            NamedSharding(mesh, P(decode_axis, None)))
        bits, _bad = sd.decode_codeblocks_sharded(
            buf_p, seg.base_graph, seg.lifting_size, mesh,
            nof_iterations=cfg.nof_ldpc_iterations, axis=decode_axis,
            n_cb=cfg.sch.n_cb)
        tb, ok = _desegment_stage(bits[:c], cfg.sch, ())
        return {"tb_bits": tb, "tb_crc_ok": ok, "noise_var": nv,
                "snr_db": 10.0 * jnp.log10(jnp.maximum(snr, 1e-12))}
    tb, ok, harq = decode_transport_block(llr, cfg.sch, cfg.nof_ldpc_iterations)
    return {"tb_bits": tb, "tb_crc_ok": ok, "harq_buffer": harq, "noise_var": nv,
            "snr_db": 10.0 * jnp.log10(jnp.maximum(snr, 1e-12))}
