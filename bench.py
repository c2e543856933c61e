"""Headline benchmark: 100 MHz 4x4 cell — full-slot PDSCH encode (DL) +
PUSCH decode (UL) throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Baseline: real-time slot rate at 30 kHz SCS is 2000 slot operations/s
(1000 DL encodes + 1000 UL decodes per second); vs_baseline = rate / 2000.

The parent process stays off JAX and runs one worker process, so only one
process opens the card.  The worker fails when JAX finds no GPU.  Every
timing ends in block_until_ready; the CRC verdict is read from the timed
decodes' own outputs.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

WORKER_TIMEOUT_S = int(os.environ.get("BENCH_WORKER_TIMEOUT_S", "1200"))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def worker() -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from srsran_project_tpu.support import platform

    platform.configure_compile_cache(min_compile_time_secs=2.0)
    dev = platform.require_gpu("bench")[0]
    from srsran_project_tpu.models import cell as cell_mod
    from srsran_project_tpu.ops import ofdm as ofdm_mod

    log = lambda msg: print(f"# {msg}", file=sys.stderr, flush=True)  # noqa: E731
    cfg = cell_mod.CellConfig()  # 273 PRB, 4x4, 256QAM
    rng = np.random.default_rng(0)
    rnti = jnp.uint32(0x4601)
    w = jnp.eye(cfg.nof_layers, cfg.nof_ports, dtype=jnp.complex64)
    tb = jnp.asarray(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
    nof_samples = ofdm_mod.slot_nof_samples(cfg.scs, cfg.dft_size, cfg.cp, 0)
    snr_db = float(os.environ.get("BENCH_SNR_DB", "30"))
    noise_unit = jnp.asarray(
        ((rng.standard_normal((cfg.nof_ports, nof_samples))
          + 1j * rng.standard_normal((cfg.nof_ports, nof_samples))) * np.sqrt(0.5)
         ).astype(np.complex64))

    t0 = time.perf_counter()
    iq = jax.block_until_ready(cell_mod.encode_slot_fused(tb, rnti, w, cfg))
    t_enc_c = time.perf_counter() - t0
    nscale = jnp.sqrt(jnp.mean(jnp.abs(iq) ** 2) * 10.0 ** (-snr_db / 10.0))
    iq_rx = iq + noise_unit * nscale.astype(jnp.complex64)
    t0 = time.perf_counter()
    jax.block_until_ready(cell_mod.decode_slot_fused(iq_rx, rnti, cfg))
    t_dec_c = time.perf_counter() - t0
    log(f"warmup (compile) encode {t_enc_c:.1f} s, decode {t_dec_c:.1f} s")

    def per_call(fn, n):
        """Seconds per call over n back-to-back dispatches."""
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        outs = [fn() for _ in range(n)]
        jax.block_until_ready(outs)
        return (time.perf_counter() - t0) / n, outs

    n = 20
    t_enc, _ = per_call(lambda: cell_mod.encode_slot_fused(tb, rnti, w, cfg), n)
    t_dec, dec_outs = per_call(lambda: cell_mod.decode_slot_fused(iq_rx, rnti, cfg), n)
    crc_ok = all(bool(o["tb_crc_ok"]) and bool((o["tb_bits"] == tb).all())
                 for o in dec_outs)
    log(f"single slot: encode {t_enc * 1e3:.3f} ms, decode {t_dec * 1e3:.3f} ms, "
        f"crc_ok={crc_ok}")
    cfg_fixed = dataclasses.replace(cfg, ldpc_early_stop=False)
    t_dec_fixed, _ = per_call(
        lambda: cell_mod.decode_slot_fused(iq_rx, rnti, cfg_fixed), n)

    # Batched slots: vmap over B slots in one program.
    b = int(os.environ.get("BENCH_SLOT_BATCH", "32"))
    tbs_b = jnp.stack([tb] * b)
    rntis_b = jnp.full((b,), 0x4601, jnp.uint32)
    iq_rx_b = jnp.stack([iq_rx] * b)
    enc_b = jax.jit(jax.vmap(lambda t, r: cell_mod.encode_slot_fused(t, r, w, cfg)))
    dec_b = jax.jit(jax.vmap(lambda x, r: cell_mod.decode_slot_fused(x, r, cfg)))
    t_enc_b, _ = per_call(lambda: enc_b(tbs_b, rntis_b), 8)
    t_dec_b, outs_b = per_call(lambda: dec_b(iq_rx_b, rntis_b), 8)
    t_enc_b, t_dec_b = t_enc_b / b, t_dec_b / b
    crc_ok = crc_ok and all(bool(o["tb_crc_ok"].all())
                            and bool((o["tb_bits"] == tb[None]).all()) for o in outs_b)
    log(f"batched x{b}: encode {t_enc_b * 1e3:.3f} ms/slot, "
        f"decode {t_dec_b * 1e3:.3f} ms/slot")

    # One slot in flight: per-slot latency against the 2.5 ms budget
    # (500 us slot, reference max_processing_delay_slots = 5).
    lat = []
    for _ in range(30):
        for fn in (lambda: cell_mod.encode_slot_fused(tb, rnti, w, cfg),
                   lambda: cell_mod.decode_slot_fused(iq_rx, rnti, cfg)):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)

    rate = 1.0 / t_enc_b + 1.0 / t_dec_b
    result = {
        "metric": "pdsch_encode+pusch_decode_slot_rate_100mhz_4x4",
        "value": round(rate, 1),
        "unit": "slots/s",
        "vs_baseline": round(rate / 2000.0, 3),
        "slot_batch": b,
        "encode_ms": round(t_enc * 1e3, 4),
        "decode_ms": round(t_dec * 1e3, 4),
        "decode_fixed_iter_ms": round(t_dec_fixed * 1e3, 4),
        "encode_batched_ms": round(t_enc_b * 1e3, 4),
        "decode_batched_ms": round(t_dec_b * 1e3, 4),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 4),
        "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 4),
        "deadline_miss_rate_2p5ms": float((lat > 2.5e-3).mean()),
        "decode_snr_db": snr_db,
        "crc_verified": crc_ok,
        "compile_s": {"encode": round(t_enc_c, 2), "decode": round(t_dec_c, 2)},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card()},
    }
    print("RESULT " + json.dumps(result), flush=True)


def main() -> None:
    if "--worker" in sys.argv:
        worker()
        return
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                          capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    sys.stderr.write(proc.stderr[-4000:])
    results = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    if proc.returncode != 0 or not results:
        sys.exit(proc.returncode or 1)
    print(results[-1][len("RESULT "):])


if __name__ == "__main__":
    main()
