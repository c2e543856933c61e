#!/usr/bin/env python3
"""BLER parity vs the reference, at the reference's own operating points.

The reference side is MEASURED, not assumed: tools/refgen's bler_parity
suite compiles the reference pusch chain (pdsch encode -> the in-tree
pxsch_bler_test TDL channel emulator -> pusch_processor) and records
BLER + LDPC iteration statistics per operating point into
tests/golden/bler_parity/manifest.json.  This script replays the same
points through this framework's chain (transmit -> TDL emulator -> front
end -> LDPC decode with per-codeblock iteration counts, on the backend's
decoder) and writes BLER_PARITY.md side by side, naming the device.

Both emulators draw uncorrelated TDL-profile taps per slot, so BLER
matches statistically (binomial CI at 300 slots reported alongside).

Usage: python benchmarks/bler_parity.py [--slots N] [--out BLER_PARITY.md]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def run_case(case, nof_slots, chunk=50, parity_kernels=False):
    import jax
    import jax.numpy as jnp

    from srsran_project_tpu.ops.modulation import Modulation
    from srsran_project_tpu.ops.ldpc import decoder as ldpc_decoder
    from srsran_project_tpu.ops.ldpc import decoder_cuda
    from srsran_project_tpu.phy import channel_emulator as chem
    from srsran_project_tpu.phy import pusch
    from srsran_project_tpu.phy.allocation import Allocation
    from srsran_project_tpu.phy.sch import _dematch_stage, _desegment_stage
    from srsran_project_tpu.support import platform

    prof = {"TDLA": "tdla", "TDLB": "tdlb", "TDLC": "tdlc",
            "single-tap": "single"}[case["profile"]]
    nof_prb = case["nof_prb"]
    nl = int(case.get("layers", 1))
    mod = Modulation(case["qm"])
    alloc = Allocation(rb_start=0, rb_count=nof_prb, sym_start=0,
                       sym_count=14, dmrs_symbols=(2, 11))
    extra = {}
    if parity_kernels:
        # The reference-parity kernel selections (golden-tested): the
        # 31-tap reference estimator closes the fast path's documented
        # ~1 dB deficit on high-delay-spread TDL profiles.
        extra = dict(estimator="reference")
    # Match the equalizer ALGORITHM the reference side measured with:
    # rank >1 reference rows run ZF (its open-source MMSE is 1-layer only,
    # channel_equalizer_generic_impl.cpp is_supported); rank-4 rows that
    # only this chain runs (ref_unsupported) keep the production MMSE.
    if case.get("equalizer") == "zf" and not case.get("ref_unsupported"):
        extra["equalizer"] = "zf"
    cfg = pusch.PuschConfig(
        tbs=case["tbs"], target_code_rate=case["rate"], modulation=mod,
        alloc=alloc, nof_layers=nl, nof_rx_ports=nl, nof_grid_symbols=14,
        nof_grid_sc=nof_prb * 12, slot_in_frame=1, dmrs_scrambling_id=1,
        n_id=1, **extra)
    ch = chem.ChannelConfig(profile=prof, sinr_db=case["sinr_db"],
                            nof_tx_ports=nl, nof_rx_ports=nl,
                            nof_sc=nof_prb * 12,
                            noise_convention="fixed")
    seg = cfg.sch.seg
    on_kernel = platform.ldpc_decoder() == "cuda"

    def one_slot(tb, key):
        grid = pusch.transmit(tb, jnp.uint32(0x4601), cfg)
        rx, _h, _nv = chem.apply_channel(grid, key, ch)
        llr_i8, _nvar, _snr = pusch._front_end(rx, jnp.uint32(0x4601), cfg)
        buf = _dematch_stage(llr_i8, None, cfg.sch)
        if on_kernel:
            bits, iters = decoder_cuda.decode(
                buf, seg.base_graph, seg.lifting_size, 6, early_stop=True,
                n_cb=cfg.sch.n_cb)
        else:
            bits, _app, iters = ldpc_decoder.decode_count_iters(
                buf.astype(jnp.float32), seg.base_graph, seg.lifting_size, 6)
        tb_hat, ok = _desegment_stage(bits, cfg.sch, ())
        data_ok = ok & jnp.all(tb_hat == tb)
        return ok.astype(jnp.int32), data_ok.astype(jnp.int32), iters

    batch = jax.jit(jax.vmap(one_slot))
    rng = np.random.default_rng(0xB1E5)
    key = jax.random.PRNGKey(1)
    crc_err = data_err = 0
    it_all = []
    done = 0
    while done < nof_slots:
        n = min(chunk, nof_slots - done)
        tbs = jnp.asarray(rng.integers(0, 2, size=(n, case["tbs"]),
                                       dtype=np.uint8))
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, n)
        ok, dok, iters = batch(tbs, keys)
        crc_err += int(np.asarray((1 - ok).sum()))
        data_err += int(np.asarray((1 - dok).sum()))
        it_all.append(np.asarray(iters).reshape(-1))
        done += n
    it = np.concatenate(it_all)
    return {
        "crc_bler": crc_err / nof_slots,
        "data_bler": data_err / nof_slots,
        "iter_mean": float(it.mean()),
        "iter_min": int(it.min()),
        "iter_max": int(it.max()),
        "nof_slots": nof_slots,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=300)
    ap.add_argument("--out", default="BLER_PARITY.md")
    args = ap.parse_args()
    import jax

    from srsran_project_tpu.support import platform

    platform.configure_compile_cache()
    dev = jax.devices()[0]
    man = os.path.join(os.path.dirname(__file__), "..",
                       "tests", "golden", "bler_parity", "manifest.json")
    cases = json.load(open(man))
    # Rank-4 rows: the reference's OPEN-SOURCE equalizer caps at 2 layers
    # (channel_equalizer_generic_impl.cpp is_supported — ZF 1-2 layers,
    # MMSE 1 layer; ranks above sit behind SRSRAN_HAS_ENTERPRISE), so rank
    # 4 is measured on this chain only (4x4 MMSE) and annotated.
    from srsran_project_tpu.ran.tbs import calculate_tbs

    base10 = next(c for c in cases if c["mcs"] == 10)
    for sinr in (14.0, 17.0):
        cases.append({
            "profile": "TDLA", "sinr_db": sinr, "mcs": 10, "nof_prb": 52,
            "layers": 4,
            "tbs": calculate_tbs(52, 14, 24, base10["rate"], base10["qm"], 4),
            "qm": base10["qm"], "rate": base10["rate"],
            "nof_slots": 0, "crc_bler": float("nan"),
            "iter_mean": float("nan"), "iter_min": 0, "iter_max": 0,
            "ref_unsupported": True,
        })
    rows = []
    for case in cases:
        ours = run_case(case, args.slots, parity_kernels=True)
        fast = run_case(case, args.slots, parity_kernels=False)
        if case.get("ref_unsupported"):
            ci = float("nan")
        else:
            ci = 1.96 * np.sqrt(max(case["crc_bler"] * (1 - case["crc_bler"]), 1e-4)
                                / case["nof_slots"])
        rows.append((case, ours, fast, ci))
        print(f"{case['profile']:>10} r{case.get('layers', 1)} "
              f"{case['sinr_db']:5.1f} dB mcs{case['mcs']:>2}: "
              f"ref {case['crc_bler']:.3f} (it {case['iter_mean']:.1f}) | "
              f"parity {ours['crc_bler']:.3f} | fast {fast['crc_bler']:.3f}",
              flush=True)

    with open(args.out, "w") as f:
        f.write(
            "# BLER parity — reference chain vs this chain, same operating "
            "points\n\n"
            "Reference numbers are MEASURED by running the reference's own "
            "pusch chain\n(pdsch encode -> the in-tree pxsch_bler_test TDL "
            "channel emulator ->\npusch_processor, compiled by tools/refgen, "
            "suite `bler_parity`) on the\nhost CPU.  This chain's numbers "
            f"replay the same operating points on\n{dev.device_kind} "
            f"({dev.platform}) with its TDL emulator.  Both draw uncorrelated\nper-slot taps; agreement "
            "is statistical (95% CI of the reference's\nmeasurement shown)."
            "\n\n"
            "Rank-N rows run N layers over an NxN i.i.d. MIMO channel "
            "(identity\nprecoding).  Rank-2 rows use the ZF equalizer on "
            "both sides — the\nalgorithm the reference's own bler harness "
            "selects (pxsch_bler_test.cpp:257);\nits open-source MMSE is "
            "single-layer-only and ranks above 2 are\nenterprise-gated "
            "(channel_equalizer_generic_impl.cpp is_supported), so\nrank-4 "
            "rows run on this chain only (4x4 MMSE).  This chain's LDPC "
            "iteration\ncounts are per-codeblock syndrome-stop statistics; "
            "the reference's are\nits CRC-stop decoder stats.\n\n"
            "| Profile | Rank | SINR dB | MCS (qam64 tbl) | TBS | ref CRC BLER "
            "(±CI) | parity kernels | fast kernels | ref LDPC "
            "iters (min/mean/max) | iters |\n"
            "|---|---|---|---|---|---|---|---|---|---|\n")
        for case, ours, fast, ci in rows:
            if case.get("ref_unsupported"):
                ref_col = "n/a (rank>2 enterprise-only)"
                ref_it = "n/a"
            else:
                ref_col = f"{case['crc_bler']:.3f} (±{ci:.3f})"
                ref_it = (f"{case['iter_min']}/{case['iter_mean']:.1f}"
                          f"/{case['iter_max']}")
            f.write(
                f"| {case['profile']} | {case.get('layers', 1)} "
                f"| {case['sinr_db']:.1f} | {case['mcs']} "
                f"| {case['tbs']} | {ref_col} "
                f"| {ours['crc_bler']:.3f} | {fast['crc_bler']:.3f} "
                f"| {ref_it} "
                f"| {ours['iter_min']}/{ours['iter_mean']:.1f}/{ours['iter_max']} |\n")
        f.write(f"\nSlots per point: reference {rows[0][0]['nof_slots']}, "
                f"this chain {rows[0][1]['nof_slots']}.\n"
                "Regenerate: `tools/refgen/build/refgen tests/golden "
                "bler_parity` then\n`python benchmarks/bler_parity.py`.\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
