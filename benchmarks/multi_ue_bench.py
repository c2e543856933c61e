#!/usr/bin/env python3
"""Multi-UE slot benchmark (BASELINE config #5).

One 100 MHz carrier FDM-split across N UEs; the whole UL slot (N PUSCH
grants) decodes in one batched device program pair (pusch.process_multi)
and the DL twin encodes N PDSCH grants in one program
(pdsch.process_multi).  Prints one JSON line per UE count with slots/s
and aggregate Mbps, mirroring the reference's multi-PDU slot shape
(uplink_processor_impl.h:149 PDU repository; benchmark modes
pusch_processor_benchmark.cpp:57-91).

Usage: python benchmarks/multi_ue_bench.py [--ues 4,8,16]
       [--prb 273] [--ports 1]

Every line is stamped with the device it ran on; every timing ends in
block_until_ready.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])



def timeit(fn, n=10):
    """Median seconds per call, each call ended by block_until_ready."""
    import time

    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind}


def run(nof_prb: int, ues: list[int], nof_ports: int) -> list[dict]:
    import jax
    import jax.numpy as jnp

    from srsran_project_tpu.ops.modulation import Modulation
    from srsran_project_tpu.phy import pdsch, pusch
    from srsran_project_tpu.phy.allocation import Allocation
    from srsran_project_tpu.ran import tbs as tbs_mod
    from srsran_project_tpu.ran.constants import NRE

    results = []
    rng = np.random.default_rng(0)
    nof_grid_sc = nof_prb * 12
    for n in ues:
        rb_each = nof_prb // n
        alloc = Allocation(rb_start=0, rb_count=rb_each, sym_start=1,
                           sym_count=12, dmrs_symbols=(2, 11))
        qm, rate = tbs_mod.mcs_to_qm_rate(20, "qam64")
        tbs = tbs_mod.calculate_tbs(rb_each, 12, NRE * 1, rate, qm, 1)
        common = dict(tbs=tbs, target_code_rate=rate,
                      modulation=Modulation(qm), nof_layers=1,
                      nof_grid_symbols=14, slot_in_frame=3)
        tx = pdsch.PdschConfig(alloc=alloc, nof_ports=nof_ports,
                               nof_grid_sc=rb_each * 12, **common)
        rx = pusch.PuschConfig(alloc=alloc, nof_rx_ports=nof_ports,
                               nof_grid_sc=rb_each * 12, **common)
        tbs_b = jnp.asarray(
            rng.integers(0, 2, size=(n, tbs), dtype=np.uint8))
        rntis = np.arange(n, dtype=np.uint32) + 0x4601
        offs = [i * rb_each for i in range(n)]
        w = np.eye(1, nof_ports, dtype=np.complex64)
        grid0 = jnp.zeros((nof_ports, 14, nof_grid_sc), jnp.complex64)

        grid = pdsch.process_multi(tbs_b, rntis, offs, w, tx, grid=grid0)
        key = jax.random.PRNGKey(0)
        noise = (jax.random.normal(key, grid.shape + (2,), jnp.float32)
                 * np.float32(np.sqrt(0.5) * 10 ** (-25.0 / 20)))
        rx_grid = grid + jax.lax.complex(noise[..., 0], noise[..., 1])

        t_dl = timeit(
            lambda: pdsch.process_multi(tbs_b, rntis, offs, w, tx, grid=grid0))
        t_ul = timeit(lambda: pusch.process_multi(rx_grid, rntis, offs, rx))
        out = pusch.process_multi(rx_grid, rntis, offs, rx)
        nof_fail = int(np.asarray((~out["tb_crc_ok"]).astype(jnp.int32).sum()))
        rate_slots = 1.0 / t_dl + 1.0 / t_ul
        results.append({
            "metric": f"multi_ue_slot_rate_{nof_prb}prb_{n}ue",
            "value": round(rate_slots, 1), "unit": "slots/s",
            "ue_count": n, "tbs_per_ue": tbs,
            "dl_ms_per_slot": round(t_dl * 1e3, 3),
            "ul_ms_per_slot": round(t_ul * 1e3, 3),
            "agg_mbps": round(n * tbs * rate_slots / 1e6, 1),
            "crc_fail": nof_fail, "device": _device(),
        })
        print(json.dumps(results[-1]), flush=True)
    return results


def run_hetero(nof_prb: int, nof_ports: int) -> dict:
    """Heterogeneous 8-UE slot (phy/ul_slot.py): two DIFFERENT configs
    (MCS 20 x 5 UEs + MCS 10 x 3 UEs, different widths) plus one PUCCH F1
    occasion decode through ONE front-end program + one LDPC program per
    distinct (bg, Z) + one finish program — the mixed PDU repository slot
    (uplink_processor_impl.h:149) as a bounded number of device programs."""
    import dataclasses as dc

    import jax.numpy as jnp

    from srsran_project_tpu.ops.modulation import Modulation
    from srsran_project_tpu.phy import pucch as pucch_mod
    from srsran_project_tpu.phy import pusch, ul_slot
    from srsran_project_tpu.phy.allocation import Allocation
    from srsran_project_tpu.ran import tbs as tbs_mod
    from srsran_project_tpu.ran.constants import NRE

    rng = np.random.default_rng(0)
    nof_grid_sc = nof_prb * 12
    rb_a = (nof_prb - 3) // 7  # 5 UEs of rb_a + 3 UEs of ~2/3 rb_a + F1
    rb_b = (nof_prb - 1 - 5 * rb_a) // 3

    def mk(rb, mcs):
        qm, rate = tbs_mod.mcs_to_qm_rate(mcs, "qam64")
        tbs = tbs_mod.calculate_tbs(rb, 12, NRE * 1, rate, qm, 1)
        return pusch.PuschConfig(
            tbs=tbs, target_code_rate=rate, modulation=Modulation(qm),
            alloc=Allocation(rb_start=0, rb_count=rb, sym_start=1,
                             sym_count=12, dmrs_symbols=(2, 11)),
            nof_layers=1, nof_rx_ports=nof_ports, nof_grid_symbols=14,
            nof_grid_sc=rb * 12, slot_in_frame=3)

    cfg_a, cfg_b = mk(rb_a, 20), mk(rb_b, 10)
    plan = [(cfg_a, i * rb_a) for i in range(5)] + \
           [(cfg_b, 5 * rb_a + i * rb_b) for i in range(3)]
    grid = np.zeros((nof_ports, 14, nof_grid_sc), np.complex64)
    pdus = []
    for i, (cfg, rb0) in enumerate(plan):
        tb = jnp.asarray(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
        cfg_tx = dc.replace(cfg, alloc=dc.replace(cfg.alloc, crb_start=rb0))
        sub = np.asarray(pusch.transmit(tb, jnp.uint32(0x4601 + i), cfg_tx))
        grid[:1, :, rb0 * 12: rb0 * 12 + cfg.nof_grid_sc] += sub
        pdus.append(ul_slot.UlSlotPdu(rnti=0x4601 + i, first_rb=rb0,
                                      config=cfg_tx))
    f1 = pucch_mod.PucchFormat1Config(
        prb=nof_prb - 1, start_symbol=0, nof_symbols=14,
        initial_cyclic_shift=3, occ_index=1, n_id=42, slot_in_frame=3,
        nof_harq_bits=2)
    grid[0, 0:14, (nof_prb - 1) * 12: nof_prb * 12] += 0.8 * np.asarray(
        pucch_mod.format1_generate(f1, np.asarray([1, 0], np.uint8)))
    grid += (rng.standard_normal(grid.shape)
             + 1j * rng.standard_normal(grid.shape)).astype(np.complex64) \
        * np.float32(10 ** (-25.0 / 20) * np.sqrt(0.5))
    grid_d = jnp.asarray(grid.astype(np.complex64))

    t = timeit(lambda: ul_slot.process_slot(grid_d, pdus, (f1,))[0]
                        [0]["tb_bits"])
    # Per-PDU comparison: the same slot as 8 individual process() calls +
    # a standalone F1 detect — the host-loop shape the slot program
    # replaces (each PDU pays its own program dispatches).
    import jax

    def per_pdu():
        outs = []
        for pdu in pdus:
            win = jax.lax.dynamic_slice(
                grid_d, (0, 0, pdu.first_rb * 12),
                (grid_d.shape[0], grid_d.shape[1], pdu.config.nof_grid_sc))
            outs.append(pusch.process(win, jnp.uint32(pdu.rnti),
                                      pdu.config)["tb_bits"])
        outs.append(pucch_mod.format1_detect(grid_d, f1)[0])
        return outs

    t_pdu = timeit(per_pdu, n=5)
    results, f1_res, _f0 = ul_slot.process_slot(grid_d, pdus, (f1,))
    nof_fail = sum(1 for r in results
                   if not bool(np.asarray(r["tb_crc_ok"])))
    out = {
        "metric": f"hetero_slot_rate_{nof_prb}prb_8ue_2cfg_pucch",
        "value": round(1.0 / t, 1), "unit": "slots/s",
        "ul_ms_per_slot": round(t * 1e3, 3),
        "per_pdu_ms_per_slot": round(t_pdu * 1e3, 3),
        "speedup_vs_per_pdu": round(t_pdu / t, 2),
        "ue_count": 8, "distinct_configs": 2, "pucch_f1": 1,
        "crc_fail": nof_fail,
        "f1_bits_ok": bool((np.asarray(f1_res[0][0]) ==
                            np.asarray([1, 0])).all()),
        "device": _device(),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ues", default="4,8,16")
    ap.add_argument("--prb", type=int, default=273)
    ap.add_argument("--ports", type=int, default=1)
    ap.add_argument("--hetero", action="store_true",
                    help="mixed-config 8-UE + PUCCH slot (phy/ul_slot.py)")
    args = ap.parse_args()
    from srsran_project_tpu.support import platform

    platform.configure_compile_cache()
    if args.hetero:
        run_hetero(args.prb, args.ports)
        return
    run(args.prb, [int(x) for x in args.ues.split(",")], args.ports)


if __name__ == "__main__":
    main()
