"""Deadline-aware slot latency benchmark (counterpart of the reference's
pusch_processor_benchmark latency mode, tests/benchmarks/phy/upper/
channel_processors/pusch/pusch_processor_benchmark.cpp:57-91).

Where bench.py measures batched throughput (slots/s), this measures the
per-slot wall-clock latency distribution of single-slot dispatch — the
number that matters against the slot deadline (500 us at 30 kHz SCS; the
reference pipelines max_processing_delay_slots=5 deep, i.e. a slot's result
may take 5 slot periods, 2.5 ms, before it is late).

Modes:
  single  — one slot in flight: dispatch, block, measure (worst case)
  pipe N  — N slots in flight (the deployment shape): per-slot completion
            intervals measured at the drain side

Prints p50/p90/p99/max per direction plus the deadline-miss rate against
the pipelined budget.

Usage: python benchmarks/latency_bench.py [--depth 4] [--slots 100] [--nof-rb 273]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp


def pct(xs, p):
    return float(np.percentile(np.asarray(xs) * 1e3, p))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=4, help="slots in flight (pipeline mode)")
    ap.add_argument("--slots", type=int, default=100)
    ap.add_argument("--scs-khz", type=int, default=30)
    ap.add_argument("--nof-rb", type=int, default=273,
                    help="273 = the flagship CellConfig(); else a small 2x2 cell")
    args = ap.parse_args()

    from srsran_project_tpu.models import cell as cell_mod
    from srsran_project_tpu.ops import ofdm as ofdm_mod
    from srsran_project_tpu.support import platform, staging

    platform.configure_compile_cache()
    dev = jax.devices()[0]
    cfg = (cell_mod.CellConfig() if args.nof_rb == 273
           else cell_mod.tiny_cell(args.nof_rb, 2))
    slot_s = 1e-3 / (args.scs_khz // 15)
    budget_s = 5 * slot_s  # max_processing_delay_slots = 5 (reference default)
    rng = np.random.default_rng(0)
    rnti = jnp.uint32(0x4601)
    w = jnp.eye(cfg.nof_layers, cfg.nof_ports, dtype=jnp.complex64)
    tb = jnp.asarray(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
    ns = ofdm_mod.slot_nof_samples(cfg.scs, cfg.dft_size, cfg.cp, 0)
    noise = jnp.asarray(
        ((rng.standard_normal((cfg.nof_ports, ns))
          + 1j * rng.standard_normal((cfg.nof_ports, ns))) * np.sqrt(1e-4 / 2)
         ).astype(np.complex64))
    jax.block_until_ready((rnti, w, tb, noise))

    with staging.sync_stages():
        iq = cell_mod.encode_slot(tb, rnti, w, cfg)
        iq.block_until_ready()
        iq_rx = iq + noise
        out = cell_mod.decode_slot(iq_rx, rnti, cfg)
        jax.block_until_ready(out["tb_bits"])
    print(f"# warmup done ({cfg.nof_rb} PRB, {cfg.nof_ports}x{cfg.nof_layers}) "
          f"on {dev.device_kind} ({dev.platform})", flush=True)

    def run_single(fn, n):
        lats = []
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            lats.append(time.perf_counter() - t0)
        return lats

    def run_pipelined(fn, n, depth):
        """Dispatch keeping `depth` slots in flight; measure per-slot
        completion latency from its own dispatch time."""
        from collections import deque

        inflight = deque()
        lats = []
        for i in range(n + depth):
            if i < n:
                inflight.append((time.perf_counter(), fn()))
            if len(inflight) >= depth or i >= n:
                if not inflight:
                    break
                t0, h = inflight.popleft()
                jax.block_until_ready(h)
                lats.append(time.perf_counter() - t0)
        return lats

    enc = lambda: cell_mod.encode_slot(tb, rnti, w, cfg)
    dec = lambda: cell_mod.decode_slot(iq_rx, rnti, cfg)["tb_bits"]

    report = {}
    for name, fn in (("encode", enc), ("decode", dec)):
        ls = run_single(fn, args.slots)
        lp = run_pipelined(fn, args.slots, args.depth)
        miss = sum(1 for x in lp if x > budget_s) / len(lp)
        report[name] = (ls, lp, miss)
        print(f"{name:7s} single  p50 {pct(ls,50):7.3f}  p90 {pct(ls,90):7.3f}  "
              f"p99 {pct(ls,99):7.3f}  max {pct(ls,100):7.3f} ms", flush=True)
        print(f"{name:7s} pipe{args.depth}   p50 {pct(lp,50):7.3f}  p90 {pct(lp,90):7.3f}  "
              f"p99 {pct(lp,99):7.3f}  max {pct(lp,100):7.3f} ms   "
              f"deadline(<{budget_s*1e3:.1f}ms) miss {miss*100:.1f}%", flush=True)

    ok = all(m < 0.05 for _, _, m in report.values())
    print(f"# verdict: {'PASS' if ok else 'MISS'} (pipelined p-miss < 5% both ways)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
