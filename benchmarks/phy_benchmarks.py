#!/usr/bin/env python3
"""Per-component PHY micro-benchmarks.

Counterpart of the reference's benchmark harness (SURVEY.md §6: 29 binaries
under tests/benchmarks/).  Each benchmark warms up its jitted program,
times N steady-state calls (each ended by block_until_ready), and prints
one JSON line per metric in the reference's comparison axes (throughput
per component), stamped with the device it ran on.

Usage:
  python benchmarks/phy_benchmarks.py [--only ldpc_dec,demap]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def _timeit(fn, n=20):
    """Median seconds per call, each call ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_ldpc_encoder():
    import jax.numpy as jnp
    from srsran_project_tpu.ops.ldpc import encoder, graphs

    bg, z, c = 1, 384, 141
    g = graphs.get_graph(bg, z)
    rng = np.random.default_rng(0)
    msg = jnp.asarray(rng.integers(0, 2, size=(c, g.kb * z), dtype=np.uint8))
    dt = _timeit(lambda: encoder.encode(msg, bg, z))
    bits = c * g.kb * z
    return {"metric": "ldpc_encoder_throughput", "value": round(bits / dt / 1e9, 3),
            "unit": "Gbps", "detail": f"{c} CBs BG{bg} Z={z}, {dt*1e3:.2f} ms"}


def bench_ldpc_decoder():
    import jax.numpy as jnp
    from srsran_project_tpu.ops.ldpc import decoder, decoder_cuda, encoder, graphs
    from srsran_project_tpu.support import platform

    bg, z, c, iters = 1, 384, 141, 6
    g = graphs.get_graph(bg, z)
    rng = np.random.default_rng(0)
    msg = jnp.asarray(rng.integers(0, 2, size=(c, g.kb * z), dtype=np.uint8))
    cw = encoder.encode(msg, bg, z)
    llr = jnp.where(cw[:, 2 * z:] == 0, 20, -20).astype(jnp.int8)
    if platform.ldpc_decoder() == "cuda":
        dt = _timeit(lambda: decoder_cuda.decode(llr, bg, z, iters)[0])
    else:
        dt = _timeit(lambda: decoder.decode(llr.astype(jnp.float32), bg, z, iters)[0])
    bits = c * g.kb * z
    return {"metric": "ldpc_decoder_throughput", "value": round(bits / dt / 1e9, 3),
            "unit": "Gbps", "detail": f"{c} CBs BG{bg} Z={z} x{iters} iters, {dt*1e3:.2f} ms"}


def bench_crc():
    import jax.numpy as jnp
    from srsran_project_tpu.ops import crc

    rng = np.random.default_rng(0)
    bits = jnp.asarray(rng.integers(0, 2, size=(1060864,), dtype=np.uint8))
    dt = _timeit(lambda: crc.crc(bits, "24A"))
    return {"metric": "crc24a_throughput", "value": round(bits.size / dt / 1e9, 3),
            "unit": "Gbps", "detail": f"1.06 Mbit TB, {dt*1e3:.3f} ms"}


def bench_modulation():
    import jax.numpy as jnp
    from srsran_project_tpu.ops.modulation import Modulation, map_bits
    from srsran_project_tpu.ops import scrambling

    rng = np.random.default_rng(0)
    nbits = 1257984
    bits = jnp.asarray(rng.integers(0, 2, size=(nbits,), dtype=np.uint8))

    def chain():
        s = scrambling.scramble_bits(bits, jnp.uint32(0x4601 << 15))
        return map_bits(s, Modulation.QAM256)

    dt = _timeit(chain)
    return {"metric": "scramble+map256_rate", "value": round(nbits / 8 / dt / 1e6, 1),
            "unit": "Msym/s", "detail": f"{dt*1e3:.2f} ms per codeword"}


def bench_demapper():
    import jax.numpy as jnp
    from srsran_project_tpu.ops.modulation import Modulation, demap_soft

    rng = np.random.default_rng(0)
    n = 157248
    syms = jnp.asarray((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64))
    nvar = jnp.full((n,), 0.01, jnp.float32)
    dt = _timeit(lambda: demap_soft(syms, nvar, Modulation.QAM256))
    return {"metric": "demapper256_rate", "value": round(n / dt / 1e6, 1),
            "unit": "Msym/s", "detail": f"{dt*1e3:.2f} ms per slot of REs"}


def bench_equalizer():
    import jax.numpy as jnp
    from srsran_project_tpu.ops.equalizer import equalize

    rng = np.random.default_rng(0)
    nre, p, l = 39312, 4, 4
    y = jnp.asarray((rng.standard_normal((nre, p)) + 1j * rng.standard_normal((nre, p))).astype(np.complex64))
    h = jnp.asarray((rng.standard_normal((nre, p, l)) + 1j * rng.standard_normal((nre, p, l))).astype(np.complex64))
    dt = _timeit(lambda: equalize(y, h, jnp.float32(0.1))[0])
    return {"metric": "mmse_4x4_rate", "value": round(nre / dt / 1e6, 1),
            "unit": "MRE/s", "detail": f"{dt*1e3:.2f} ms per 100MHz slot"}


def bench_ofdm():
    import jax.numpy as jnp
    from srsran_project_tpu.ops import ofdm
    from srsran_project_tpu.ran.constants import CyclicPrefix, SubcarrierSpacing

    rng = np.random.default_rng(0)
    grid = jnp.asarray((rng.standard_normal((4, 14, 3276)) + 1j * rng.standard_normal((4, 14, 3276))).astype(np.complex64))
    dt = _timeit(lambda: ofdm.modulate_slot(grid, SubcarrierSpacing.KHZ30, 4096, CyclicPrefix.NORMAL, 0))
    nsamp = 4 * ofdm.slot_nof_samples(SubcarrierSpacing.KHZ30, 4096, CyclicPrefix.NORMAL, 0)
    return {"metric": "ofdm_mod_rate", "value": round(nsamp / dt / 1e6, 1),
            "unit": "Msamp/s", "detail": f"4 ports 100MHz, {dt*1e3:.2f} ms/slot"}


def bench_prach():
    import jax.numpy as jnp
    from srsran_project_tpu.phy import prach

    cfg = prach.PrachConfig(l_ra=839, zero_correlation_zone=1)
    fd = jnp.asarray(np.asarray(prach.generate_preamble(cfg, 7))[None])
    dt = _timeit(lambda: prach.detect(fd, cfg)["metric"])
    return {"metric": "prach_detector_rate", "value": round(1.0 / dt, 1),
            "unit": "occasions/s", "detail": f"64 preambles, {dt*1e3:.2f} ms"}


def bench_estimator():
    import jax.numpy as jnp
    from srsran_project_tpu.ops.estimator import estimate_channel

    rng = np.random.default_rng(0)
    npil = 1638  # 273 PRB type-1 pilots per CDM group
    y = jnp.asarray((rng.standard_normal((4, 1, npil)) + 1j * rng.standard_normal((4, 1, npil))).astype(np.complex64))
    ref = jnp.asarray(np.ones((1, 1, npil), np.complex64))
    wf = jnp.ones((npil,), jnp.float32)
    pp = tuple(float(4 * i + 1) for i in range(npil // 2))
    dt = _timeit(lambda: estimate_channel(y, ref, wf, pp, 3276)[0])
    return {"metric": "channel_estimator_rate", "value": round(4 / dt, 1),
            "unit": "port-layers/s", "detail": f"273 PRB, {dt*1e3:.2f} ms per (4 ports x 1 layer)"}


def bench_bfp():
    from srsran_project_tpu.support import native

    rng = np.random.default_rng(0)
    x = rng.integers(-30000, 30000, size=24 * 273 * 14, dtype=np.int16)
    t0 = time.time()
    for _ in range(10):
        c = native.bfp_compress(x, 9)
    dt = (time.time() - t0) / 10
    return {"metric": "bfp_compression_rate", "value": round(x.size / 2 / dt / 1e6, 1),
            "unit": "Msamp/s", "detail": f"one slot of 273 PRB IQ, {dt*1e3:.2f} ms"}


ALL = {
    "ldpc_enc": bench_ldpc_encoder,
    "ldpc_dec": bench_ldpc_decoder,
    "crc": bench_crc,
    "mod": bench_modulation,
    "demap": bench_demapper,
    "eq": bench_equalizer,
    "ofdm": bench_ofdm,
    "prach": bench_prach,
    "est": bench_estimator,
    "bfp": bench_bfp,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    import jax

    from srsran_project_tpu.support import platform

    platform.configure_compile_cache()
    dev = jax.devices()[0]
    stamp = {"platform": dev.platform, "kind": dev.device_kind}
    names = args.only.split(",") if args.only else list(ALL)
    for name in names:
        print(json.dumps({**ALL[name](), "device": stamp}), flush=True)


if __name__ == "__main__":
    main()
