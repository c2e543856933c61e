"""Heterogeneous multi-UE uplink slot program.

The reference's uplink slot is a MIXED PDU repository processed per slot
(uplink_processor_impl.h:149): one slot carries PUSCH grants of different
MCS/allocation widths plus PUCCH occasions, and the per-PDU work is
dispatched into a task pool.  On an accelerator every dispatched program
has a fixed host cost, so the shape here is the opposite: ONE compiled
front-end program covers EVERY PUSCH grant in the slot — mixed configs
included — with PUCCH F0/F1/F2 occasions folded into the same program, and the
LDPC decode batches all grants' codeblocks per (base-graph, lifting-size)
group.  An 8-UE slot with 3 distinct configs + PUCCH runs in

    1 (front end + rate dematch + PUCCH)  +  #distinct (bg, Z) decodes
    (usually 1)  +  1 (desegment + CRC)

device programs, independent of the number of UEs.  UCI-on-PUSCH (fixed
part-2 size) and PT-RS grants fold into the same program — the
demultiplex placement and PT-RS CPE tracking are static per config; the
per-PDU fallback remains only for PRACH and two-step CSI (part-2 size
follows the decoded RI).

Mechanics: the slot program's STATIC signature is the tuple of distinct
(config, count) groups, so XLA specializes one program per recurring slot
shape (the persistent compilation cache amortizes across slots — the
scheduler re-produces the same shapes in steady state).  Within a group
the grants batch by vmap exactly like pusch.process_multi; across groups
the sub-chains inline into the same program and XLA schedules them
side by side.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import pusch as pusch_mod
from .pusch import PuschConfig
from .sch import _dematch_stage, _desegment_stage


@functools.partial(jax.jit,
                   static_argnames=("cfgs", "f1_cfgs", "f0_cfgs", "f2_cfgs"))
def _slot_front(grid, rntis_g, sc0_g, rbank_g, harq_g, cfgs, f1_cfgs,
                f0_cfgs=(), f2_cfgs=()):
    """One compiled program: batched front end + rate dematch + in-slot
    UCI demultiplex for every config group, plus PUCCH F0/F1/F2.

    cfgs: tuple[PuschConfig] (crb_start-normalized, one per group);
    rntis_g/sc0_g/rbank_g/harq_g: per-group stacked arrays (harq may be
    None for an all-new-data group).  Returns (per-group tuples of
    (codeword-buffer (Ni, C, N) i8, nv (Ni,), snr (Ni,), ta (Ni,)),
    per-F1 tuples of (bits, metric)).
    """
    outs = []
    for cfg, rntis, sc0s, r_b, hq in zip(cfgs, rntis_g, sc0_g, rbank_g, harq_g):
        def one(rnti, sc0, r_ov, cfg=cfg):
            win = jax.lax.dynamic_slice(
                grid, (0, 0, sc0),
                (grid.shape[0], grid.shape[1], cfg.nof_grid_sc))
            est = pusch_mod._estimate_stage(win, cfg, r_override=r_ov)
            gflat, h, nv, snr = est[:4]
            x_hat, eq_nvar = pusch_mod._equalize_stage(gflat, h, nv, cfg)
            if cfg.transform_precoding:
                x_hat, eq_nvar = pusch_mod._deprecode_stage(x_hat, eq_nvar, cfg)
            llr_i8, sinr_pe = pusch_mod._demap_stage(x_hat, eq_nvar, rnti, cfg)
            if cfg.sinr_method == "post_equalization":
                snr = sinr_pe
            ta = est[4] if cfg.compute_ta else jnp.float32(0.0)
            return llr_i8, nv, snr, ta

        llrs, nvs, snrs, tas = jax.vmap(one)(rntis, sc0s, r_b)
        # In-slot UCI-on-PUSCH: static demultiplex placement + batched
        # UCI decode INSIDE the slot program (reference
        # ulsch_demultiplex_impl.cpp runs in the standard slot path), so
        # such a grant costs no extra per-PDU dispatch.
        uci = {}
        if cfg.uci_mux is not None:
            from . import ulsch_demux

            data_llrs, ack_llrs, csi_llrs, csi2_llrs = ulsch_demux.demultiplex(
                llrs, cfg.uci_mux)
            parts = ulsch_demux.decode_uci_parts(
                ack_llrs, csi_llrs, cfg.uci.nof_harq_ack_bits,
                cfg.uci.nof_csi1_bits, csi2_llrs=csi2_llrs,
                nof_csi2_bits=cfg.uci.nof_csi2_bits)
            for part, keys in (("ack", ("harq_ack_bits", "harq_ack_ok")),
                               ("csi1", ("csi1_bits", "csi1_ok")),
                               ("csi2", ("csi2_bits", "csi2_ok"))):
                if part in parts:
                    uci[keys[0]], uci[keys[1]] = parts[part]
            llrs = data_llrs
        harq = _dematch_stage(llrs, hq, cfg.sch)
        # The int8 codeword buffer IS the decoder input (the GPU kernel
        # takes int8 LLRs directly; the f32 view would cost 4x the read).
        outs.append((harq, nvs, snrs, tas, uci))

    from . import pucch as pucch_mod

    f1_outs = []
    for f1 in f1_cfgs:
        bits, _llrs, metric = pucch_mod.format1_detect(grid, f1)
        f1_outs.append((bits, metric))
    f0_outs = []
    for f0 in f0_cfgs:
        val, metric, _powers = pucch_mod.format0_detect(grid, f0)
        f0_outs.append((val, metric))
    # PUCCH F2 (UCI on PUCCH): config-static estimate/equalize/decode,
    # inlined into the same slot program like F0/F1.
    f2_outs = []
    if f2_cfgs:
        from . import pucch_f2 as f2_mod

        for f2 in f2_cfgs:
            bits, ok, snr_db = f2_mod.process(grid, f2)
            f2_outs.append((bits, ok, snr_db))
    return tuple(outs), tuple(f1_outs), tuple(f0_outs), tuple(f2_outs)


@functools.partial(jax.jit, static_argnames=("cfgs", "lead_ns"))
def _slot_finish(bits_g, cfgs, lead_ns):
    """Desegment + TB CRC for every group, one compiled program."""
    return tuple(
        _desegment_stage(bits, cfg.sch, (n,))
        for bits, cfg, n in zip(bits_g, cfgs, lead_ns))


def _decode_group(llr_i8, bg, z, nof_iterations, early_stop, n_cb=None):
    """(C', N) int8 codeword-buffer LLRs -> (C', K) bits, batching every
    grant's codeblocks through the backend's LDPC decoder
    (support/platform.py), LBRM layer truncation included."""
    from ..ops.ldpc import decoder as ldpc_decoder
    from ..ops.ldpc import decoder_cuda as ldpc_decoder_cuda
    from ..support import platform

    if platform.ldpc_decoder() == "cuda":
        return ldpc_decoder_cuda.decode(llr_i8, bg, z, nof_iterations,
                                        early_stop=early_stop, n_cb=n_cb)[0]
    return ldpc_decoder.decode(llr_i8.astype(jnp.float32), bg, z,
                               nof_iterations, n_cb=n_cb)[0]


@functools.lru_cache(maxsize=512)
def _grant_arrays_device(rntis: tuple, first_rbs: tuple):
    """Device-resident per-group grant arrays: the scheduler reproduces
    the same grant shapes in steady state, so these cache like the pilot
    banks and skip a host-to-device copy per slot.  BOUNDED: a churning UE
    population would otherwise pin device arrays without limit."""
    return (jnp.asarray(rntis, jnp.uint32),
            jnp.asarray([12 * r for r in first_rbs], jnp.int32))


@functools.lru_cache(maxsize=256)
def _pilot_bank_device(cfg: PuschConfig, first_rbs: tuple):
    """Device-resident per-grant DM-RS pilot bank: uploaded once per
    (config, PRB-offset tuple) instead of once per slot."""
    return jax.device_put(pusch_mod._multi_pilot_bank(cfg, first_rbs))


@dataclasses.dataclass
class UlSlotPdu:
    """One PUSCH grant of the heterogeneous slot."""
    rnti: int
    first_rb: int
    config: PuschConfig  # compact window config (rb_start=0)
    harq_buffer: object | None = None  # (C, N) int8 for retransmissions


def process_slot(grid, pdus, f1_cfgs=(), f0_cfgs=(), f2_cfgs=()):
    """Decode a heterogeneous multi-UE UL slot.

    grid: (P, S, nof_grid_sc) received slot grid; pdus: list[UlSlotPdu]
    with MIXED configs (different MCS / rb_count / layers allowed);
    f1_cfgs/f0_cfgs/f2_cfgs: PUCCH F1/F0/F2 occasions decoded inside the
    same front-end program.

    Returns (results, f1_results, f0_results[, f2_results when f2_cfgs]):
    results[i] is a dict per input PDU (tb_bits, tb_crc_ok, harq_buffer,
    noise_var, snr_db); f1_results[j] is (bits, metric); f0_results[k]
    is (value, metric); f2_results[m] is (uci_bits, ok, snr_db).
    """
    # ---- group by normalized static config (order-preserving) ----------
    groups: dict[PuschConfig, list[int]] = {}
    for i, pdu in enumerate(pdus):
        c = pdu.config
        if c.uci is not None and c.uci.csi_report_cfg is not None:
            raise ValueError(
                "two-step CSI PDUs take the per-PDU path (part-2 size "
                "follows the decoded RI)")
        # PT-RS expected values are seeded by the grant's ABSOLUTE CRB
        # (like the DM-RS gold sequence — but unlike DM-RS they are baked
        # into the static program, not fed via r_override), so PT-RS
        # configs keep their crb_start in the group key; everything else
        # normalizes to a compact window config shared across offsets.
        key = dataclasses.replace(
            c, alloc=dataclasses.replace(
                c.alloc,
                crb_start=c.alloc.crb_start if c.ptrs_enabled else 0))
        groups.setdefault(key, []).append(i)

    cfgs = tuple(groups.keys())
    rntis_g, sc0_g, rbank_g, harq_g = [], [], [], []
    for cfg, idxs in groups.items():
        first_rbs = tuple(int(pdus[i].first_rb) for i in idxs)
        rntis, sc0s = _grant_arrays_device(
            tuple(int(pdus[i].rnti) for i in idxs), first_rbs)
        rntis_g.append(rntis)
        sc0_g.append(sc0s)
        rbank_g.append(_pilot_bank_device(cfg, first_rbs))
        if any(pdus[i].harq_buffer is not None for i in idxs):
            seg = cfg.sch.seg
            zeros = None
            bufs = []
            for i in idxs:
                b = pdus[i].harq_buffer
                if b is None:
                    if zeros is None:
                        n = seg.nof_codeblocks
                        nllr = None
                        for j in idxs:
                            if pdus[j].harq_buffer is not None:
                                nllr = pdus[j].harq_buffer.shape[-1]
                                break
                        zeros = jnp.zeros((n, nllr), jnp.int8)
                    b = zeros
                bufs.append(b)
            harq_g.append(jnp.stack(bufs))
        else:
            harq_g.append(None)

    fronts, f1_outs, f0_outs, f2_outs = _slot_front(
        grid, tuple(rntis_g), tuple(sc0_g), tuple(rbank_g), tuple(harq_g),
        cfgs, tuple(f1_cfgs), tuple(f0_cfgs), tuple(f2_cfgs))

    # ---- decode: batch codeblocks per (bg, z, iters, early_stop) -------
    by_code: dict[tuple, list[int]] = {}
    for gi, cfg in enumerate(cfgs):
        seg = cfg.sch.seg
        key = (seg.base_graph, seg.lifting_size, cfg.nof_ldpc_iterations,
               cfg.ldpc_early_stop, cfg.sch.n_cb)
        by_code.setdefault(key, []).append(gi)
    bits_g: list = [None] * len(cfgs)
    for (bg, z, iters, es, n_cb), gis in by_code.items():
        flats = [fronts[gi][0].reshape((-1,) + fronts[gi][0].shape[-1:])
                 for gi in gis]  # (Ni*C, N) int8 codeword buffers
        sizes = [f.shape[0] for f in flats]
        bits_all = _decode_group(jnp.concatenate(flats, axis=0), bg, z,
                                 iters, es, n_cb=n_cb)
        off = 0
        for gi, n in zip(gis, sizes):
            bits_g[gi] = bits_all[off : off + n]
            off += n

    finished = _slot_finish(tuple(bits_g), cfgs,
                            tuple(len(idxs) for idxs in groups.values()))

    # ---- scatter back to input order ----------------------------------
    results: list[dict | None] = [None] * len(pdus)
    for (cfg, idxs), (harq, nvs, snrs, tas, uci), (tb, ok) in zip(
            groups.items(), fronts, finished):
        for k, i in enumerate(idxs):
            results[i] = {
                "tb_bits": tb[k],
                "tb_crc_ok": ok[k],
                "harq_buffer": harq[k],
                "noise_var": nvs[k],
                "snr_db": 10.0 * jnp.log10(jnp.maximum(snrs[k], 1e-12)),
            }
            for key, v in uci.items():
                results[i][key] = v[k]
            if cfg.compute_ta:
                results[i]["ta_s"] = tas[k]
    if f2_cfgs:
        return results, list(f1_outs), list(f0_outs), list(f2_outs)
    return results, list(f1_outs), list(f0_outs)
