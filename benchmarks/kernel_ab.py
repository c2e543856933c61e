"""A/B of the hand-written GPU kernels against what XLA makes of the plain
version, on the card, at the 100 MHz 4x4 flagship (CellConfig()).

    python benchmarks/kernel_ab.py [--reps 20]

For the LDPC decoder: the kernel alone against decoder.decode (both on the
LBRM-truncated graph, 141 codeblocks of BG1 Z=384, fixed 6 iterations and
with early stop), and the whole decode_slot_fused with each, timed in turns
(xla, cuda, cuda, xla) with block_until_ready around every call.  Checks
that the kernel's hard bits equal the plain decoder's.  Also lists, per UL
stage, the library calls XLA made (cuBLAS custom calls), and times the two
forms of the 4x4 MMSE weights.  Prints one JSON line per measurement.
Needs a GPU; fails without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def timed(fn, reps: int):
    """(median, min) seconds per call, each call ended by block_until_ready."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts))


def loop_ms(step, x, reps: int = 100) -> float:
    """Device milliseconds per application of step, from one program that
    applies it reps times in a dependent chain (no per-call dispatch)."""
    import jax

    f = jax.jit(lambda v: jax.lax.fori_loop(0, reps, lambda i, c: step(c), v))
    med, _ = timed(lambda: f(x), 5)
    return med * 1e3 / reps


def custom_calls(compiled) -> list[str]:
    import re

    return sorted(set(re.findall(r'custom_call_target="([^"]+)"', compiled.as_text())))


@contextlib.contextmanager
def decoder_choice(platform, kind: str):
    """Trace with the LDPC decoder `kind` in place of the backend's."""
    orig = platform.ldpc_decoder
    platform.ldpc_decoder = lambda backend=None: kind
    try:
        yield
    finally:
        platform.ldpc_decoder = orig


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--snr-db", type=float, default=30.0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from srsran_project_tpu.support import platform

    platform.configure_compile_cache()
    dev = platform.require_gpu("kernel_ab")[0]
    from srsran_project_tpu.models import cell as cell_mod
    from srsran_project_tpu.ops import ofdm
    from srsran_project_tpu.ops.ldpc import decoder, decoder_cuda
    from srsran_project_tpu.phy import sch

    name_power = card()
    base = dict(card=name_power, device_kind=dev.device_kind)
    print(name_power, flush=True)

    t0 = time.perf_counter()
    decoder_cuda.build()
    emit(**base, what="ldpc_kernel_build_s", value=time.perf_counter() - t0)

    cfg = cell_mod.CellConfig()
    rng = np.random.default_rng(0)
    tb = jnp.asarray(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
    rnti = jnp.uint32(0x4601)
    w = jnp.eye(cfg.nof_layers, cfg.nof_ports, dtype=jnp.complex64)
    iq = cell_mod.encode_slot_fused(tb, rnti, w, cfg)
    p_sig = float(jnp.mean(jnp.abs(iq) ** 2))

    def awgn(snr_db, seed):
        r = np.random.default_rng(seed)
        n = (r.standard_normal(iq.shape) + 1j * r.standard_normal(iq.shape))
        n = n * np.sqrt(p_sig * 10 ** (-snr_db / 10) / 2)
        return iq + jnp.asarray(n.astype(np.complex64))

    iq_rx = awgn(args.snr_db, 1)
    sc = cfg.pusch_cfg.sch
    seg = sc.seg
    bg, z = seg.base_graph, seg.lifting_size

    # Kernel alone vs decoder.decode on the slot's own codeword buffer.
    for snr in (args.snr_db, 21.0):
        llr_i8, _, _ = cell_mod._ul_front_program(awgn(snr, 2), rnti, cfg)
        buf = sch._dematch_stage(llr_i8, None, sc)
        flat = buf.astype(jnp.float32)
        b_x = decoder.decode(flat, bg, z, 6, n_cb=sc.n_cb)[0]
        b_c, it_c = decoder_cuda.decode(buf, bg, z, 6, n_cb=sc.n_cb)
        b_ce, it_ce = decoder_cuda.decode(buf, bg, z, 6, early_stop=True,
                                          n_cb=sc.n_cb)
        from srsran_project_tpu.ops import crc as crc_mod

        k_prime = seg.nof_payload_bits_per_cb
        crc_ok = np.asarray(crc_mod.crc(b_x[:, :k_prime], "24B").sum(-1) == 0)
        same = np.asarray((b_x == b_c).all(-1))
        same_es = np.asarray((b_x == b_ce).all(-1))
        emit(**base, what="ldpc_kernel_vs_plain", snr_db=snr,
             codeblocks=int(same.size), crc_ok_plain=int(crc_ok.sum()),
             bitexact_fixed=int(same.sum()),
             bitexact_early_stop_on_crc_ok=int((same_es | ~crc_ok).sum()),
             iters_early_stop=np.bincount(np.asarray(it_ce)).tolist())
        if snr == args.snr_db:
            for label, fn in (
                    ("xla_fixed6", lambda: decoder.decode(flat, bg, z, 6, n_cb=sc.n_cb)[0]),
                    ("cuda_fixed6", lambda: decoder_cuda.decode(buf, bg, z, 6, n_cb=sc.n_cb)[0]),
                    ("cuda_early_stop", lambda: decoder_cuda.decode(
                        buf, bg, z, 6, early_stop=True, n_cb=sc.n_cb)[0])):
                med, mn = timed(fn, args.reps)
                emit(**base, what="ldpc_decode_alone_ms", variant=label,
                     median=med * 1e3, min=mn * 1e3)

    # Whole UL slot, in turns: decode_slot_fused traced once per decoder.
    slot = {}
    for label in ("xla", "cuda"):
        t0 = time.perf_counter()
        with decoder_choice(platform, label):
            # A fresh function per variant: JAX caches traces per function.
            comp = jax.jit(lambda x, r: cell_mod.decode_slot_fused.__wrapped__(
                x, r, cfg)).lower(iq_rx, rnti).compile()
        ct = time.perf_counter() - t0
        slot[label] = comp
        out = comp(iq_rx, rnti)
        ok = bool(out["tb_crc_ok"]) and bool((out["tb_bits"] == tb).all())
        ma = comp.memory_analysis()
        txt = comp.as_text()
        import re

        targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', txt)))
        emit(**base, what="decode_slot_fused_compile", variant=label,
             compile_s=ct, crc_ok_bitexact=ok, custom_calls=targets,
             temp_bytes=getattr(ma, "temp_size_in_bytes", None),
             arg_bytes=getattr(ma, "argument_size_in_bytes", None),
             out_bytes=getattr(ma, "output_size_in_bytes", None))
    for label in ("xla", "cuda", "cuda", "xla"):
        med, mn = timed(lambda: slot[label](iq_rx, rnti)["tb_bits"], args.reps)
        emit(**base, what="decode_slot_fused_ms", variant=label,
             median=med * 1e3, min=mn * 1e3)
    med, mn = timed(lambda: cell_mod.encode_slot_fused(tb, rnti, w, cfg), args.reps)
    emit(**base, what="encode_slot_fused_ms", median=med * 1e3, min=mn * 1e3)

    x = awgn(args.snr_db, 3)
    fft_fn = jax.jit(lambda s: ofdm.demodulate_slot(
        s, cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp, 0, f_center_hz=cfg.f_center_hz))
    med, mn = timed(lambda: fft_fn(x), args.reps)
    emit(**base, what="ofdm_demodulate_slot_ms", median=med * 1e3, min=mn * 1e3)

    # Where the UL front end's cuBLAS calls come from, stage by stage.
    from srsran_project_tpu.ops import equalizer
    from srsran_project_tpu.phy import pusch

    pc = cfg.pusch_cfg
    grid = fft_fn(x)
    est = pusch._estimate_stage(grid, pc)
    xh, nv = pusch._equalize_stage(*est[:3], pc)
    llr, _ = pusch._demap_stage(xh, nv, rnti, pc)
    buf = sch._dematch_stage(llr, None, sc)
    stages = {
        "demodulate_slot": (fft_fn, (x,)),
        "estimate": (lambda g: pusch._estimate_stage(g, pc), (grid,)),
        "equalize": (lambda a, b, c: pusch._equalize_stage(a, b, c, pc), est[:3]),
        "demap": (lambda a, b, r: pusch._demap_stage(a, b, r, pc), (xh, nv, rnti)),
        "dematch": (lambda l: sch._dematch_stage(l, None, sc), (llr,)),
        "desegment": (lambda b: sch._desegment_stage(
            decoder_cuda.decode(b, bg, z, 6, n_cb=sc.n_cb)[0], sc, ()), (buf,)),
    }
    for label, (fn, fargs) in stages.items():
        comp = jax.jit(fn).lower(*fargs).compile()
        med, mn = timed(lambda: comp(*fargs), args.reps)
        emit(**base, what="ul_stage", stage=label, custom_calls=custom_calls(comp),
             median_ms=med * 1e3, min_ms=mn * 1e3)

    # 4x4 MMSE weights: batched dot_general form against the unrolled
    # structure-of-arrays form, at the flagship's 3276 subcarriers.
    hq = jnp.moveaxis(est[1], 0, 1)  # (nsc, P, L)
    nvq = est[2]
    for label, fn in (("dot_general", lambda hh: equalizer._weights_generic(hh, nvq)),
                      ("soa", lambda hh: equalizer._weights_mmse4_soa(hh, nvq))):
        comp = jax.jit(fn).lower(hq).compile()
        emit(**base, what="mmse4_weights", variant=label,
             custom_calls=custom_calls(comp),
             device_loop_ms=loop_ms(
                 lambda hh: hh + 1e-3 * fn(hh)[0].swapaxes(-1, -2), hq))
    emit(**base, what="peak_bytes_in_use",
         value=dev.memory_stats().get("peak_bytes_in_use"))


if __name__ == "__main__":
    main()
