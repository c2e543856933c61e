"""Smoke run of the PHY slot chain on one NVIDIA GPU (or, with --four-cards,
of the sharded paths on four).

    python chip_smoke.py              # one card: phases (a)-(f)
    python chip_smoke.py --four-cards # four cards: __graft_entry__.dryrun_multichip(4)

Phases, all in this one process:
  (a) device: fail unless JAX's first device is a GPU; print the card's name
      and power limit;
  (b) flagship round trip at CellConfig() (273 PRB, 4x4, 256QAM, 141 BG1
      codeblocks): encode_slot_fused -> AWGN at 30 dB -> decode_slot_fused,
      the staged encode_slot/decode_slot, and the scan entry points; CRC OK
      and bit-exact TBs; compile seconds, memory analysis, peak memory;
  (c) the same encode and UL front end on the CPU: IQ and int8 LLRs
      compared with the GPU run;
  (d) the GPU LDPC kernel against the plain decoder on the slot's own
      codeword buffers at 30 dB and at 27 dB;
  (e) the served path: apps/du_low_sim.py on configs/cell_100mhz_4x4.yml
      with 2 UEs for a few slots, every UL CRC OK;
  (f) golden vectors on the card through the tests' own loaders.
Any failed phase exits non-zero.  The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SNR_DB = 30.0
LOW_SNR_DB = 27.0
# GPU-vs-CPU IQ: both runs take the same bits and symbols; only the f32
# FFT's rounding differs (cuFFT against the CPU's FFT), O(log2(4096) * eps)
# ~ 1e-6 of the RMS per sample.  1e-4 of the RMS leaves a 100x margin.
IQ_REL_TOL = 1e-4
# int8 LLRs: f32 rounding differences before the quantiser may move an LLR
# that sits on a quantisation boundary by one step, never more often than
# on 1 entry in 10^4.
LLR_STEP_TOL = 1
LLR_AGREE_MIN = 0.9999


def check(ok, what: str) -> None:
    """A smoke check that holds under python -O too."""
    if not ok:
        raise RuntimeError(what)


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase(name: str):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            log(f"phase {name}: start")
            out = fn(*a, **kw)
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        return run
    return wrap


@phase("a device")
def device_phase(want: int):
    from srsran_project_tpu.support import platform

    devs = platform.require_gpu("chip_smoke", want)
    print(card_line(), flush=True)
    platform.configure_compile_cache()
    return devs


@phase("b flagship round trip")
def flagship_phase(jax, jnp, np, cell_mod, cfg):
    rng = np.random.default_rng(0)
    tb = jnp.asarray(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
    rnti = jnp.uint32(0x4601)
    w = jnp.eye(cfg.nof_layers, cfg.nof_ports, dtype=jnp.complex64)

    t0 = time.perf_counter()
    enc = cell_mod.encode_slot_fused.lower(tb, rnti, w, cfg).compile()
    t_enc = time.perf_counter() - t0
    iq = jax.block_until_ready(enc(tb, rnti, w))
    p_sig = float(jnp.mean(jnp.abs(iq) ** 2))
    noise = np.random.default_rng(1).standard_normal((2,) + iq.shape)
    nstd = np.sqrt(p_sig * 10 ** (-SNR_DB / 10) / 2)
    iq_rx = iq + jnp.asarray((nstd * (noise[0] + 1j * noise[1])).astype(np.complex64))

    t0 = time.perf_counter()
    dec = cell_mod.decode_slot_fused.lower(iq_rx, rnti, cfg).compile()
    t_dec = time.perf_counter() - t0
    out = dec(iq_rx, rnti)
    ok = bool(out["tb_crc_ok"])
    errs = int((out["tb_bits"] != tb).sum())
    log(f"fused: encode compile {t_enc:.1f} s, decode compile {t_dec:.1f} s, "
        f"crc_ok={ok} bit_errors={errs} snr_est={float(out['snr_db']):.1f} dB")
    check(ok and errs == 0, "fused flagship decode failed")
    for label, comp in (("encode_slot_fused", enc), ("decode_slot_fused", dec)):
        log(f"{label} memory_analysis: {comp.memory_analysis()}")

    iq_s = cell_mod.encode_slot(tb, rnti, w, cfg)
    check(float(jnp.max(jnp.abs(iq_s - iq))) < 1e-5,
          "staged encode differs from fused encode")
    out_s = cell_mod.decode_slot(iq_rx, rnti, cfg)
    check(bool(out_s["tb_crc_ok"]) and bool(jnp.all(out_s["tb_bits"] == tb)),
          "staged decode failed")

    k, b = 2, 2
    rntis = jnp.full((k, b), 0x4601, jnp.uint32)
    energy = cell_mod.encode_slots_scan(jnp.broadcast_to(tb, (k, b) + tb.shape),
                                        rntis, w, cfg)
    e_ref = float(jnp.sum(jnp.abs(iq) ** 2))
    check(np.allclose(np.asarray(energy), e_ref, rtol=1e-4), "scan encode energy")
    ok_s, errs_s = cell_mod.decode_slots_scan(
        jnp.broadcast_to(iq_rx, (k, b) + iq_rx.shape), rntis, tb, cfg)
    check(bool(jnp.all(ok_s == 1)) and int(errs_s.sum()) == 0, "scan decode failed")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"staged and scan ({k}x{b} slots) decodes CRC OK; peak_bytes_in_use={peak}")
    return tb, rnti, w, iq, iq_rx


@phase("c same functions on the CPU")
def cpu_phase(jax, jnp, np, cell_mod, cfg, tb, rnti, w, iq, iq_rx):
    cpu = jax.devices("cpu")[0]
    put = lambda x: jax.device_put(np.asarray(x), cpu)  # noqa: E731
    iq_cpu = cell_mod.encode_slot_fused(put(tb), put(rnti), put(w), cfg)
    check(next(iter(iq_cpu.devices())).platform == "cpu", "CPU run left the CPU")
    d = np.abs(np.asarray(iq_cpu) - np.asarray(iq))
    rms = float(np.sqrt(np.mean(np.abs(np.asarray(iq)) ** 2)))
    rel = float(d.max()) / rms
    log(f"IQ GPU vs CPU: max |diff| / RMS = {rel:.3e} (limit {IQ_REL_TOL})")
    check(rel <= IQ_REL_TOL, "GPU and CPU IQ differ")

    llr_gpu = np.asarray(cell_mod._ul_front_program(iq_rx, rnti, cfg)[0], np.int32)
    llr_cpu = np.asarray(cell_mod._ul_front_program(put(iq_rx), put(rnti), cfg)[0],
                         np.int32)
    diff = np.abs(llr_gpu - llr_cpu)
    agree = float(np.mean(diff <= LLR_STEP_TOL))
    log(f"int8 LLRs GPU vs CPU: {int((diff > 0).sum())}/{diff.size} differ, "
        f"max step {int(diff.max())}, within {LLR_STEP_TOL} step: {agree:.6f}")
    check(agree >= LLR_AGREE_MIN, "GPU and CPU LLRs differ")


@phase("d LDPC kernel against the plain decoder")
def kernel_phase(jax, jnp, np, cell_mod, cfg, iq, rnti):
    from srsran_project_tpu.ops import crc as crc_mod
    from srsran_project_tpu.ops.ldpc import decoder, decoder_cuda
    from srsran_project_tpu.phy import sch

    sc = cfg.pusch_cfg.sch
    seg = sc.seg
    bg, z, k_prime = seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb
    p_sig = float(jnp.mean(jnp.abs(iq) ** 2))
    for seed, snr in ((2, SNR_DB), (3, LOW_SNR_DB)):
        noise = np.random.default_rng(seed).standard_normal((2,) + iq.shape)
        nstd = np.sqrt(p_sig * 10 ** (-snr / 10) / 2)
        rx = iq + jnp.asarray((nstd * (noise[0] + 1j * noise[1])).astype(np.complex64))
        llr_i8 = cell_mod._ul_front_program(rx, rnti, cfg)[0]
        buf = sch._dematch_stage(llr_i8, None, sc)
        ref = np.asarray(decoder.decode(buf.astype(jnp.float32), bg, z, 6,
                                        n_cb=sc.n_cb)[0])
        got, it = decoder_cuda.decode(buf, bg, z, 6, n_cb=sc.n_cb)
        got_es, it_es = decoder_cuda.decode(buf, bg, z, 6, early_stop=True, n_cb=sc.n_cb)
        got, got_es, it_es = np.asarray(got), np.asarray(got_es), np.asarray(it_es)
        crc_ok = np.asarray(crc_mod.crc(jnp.asarray(ref[:, :k_prime]), "24B").sum(-1) == 0)
        same = (got == ref).all(-1)
        same_es = (got_es == ref).all(-1)
        log(f"{snr:.0f} dB: {same.size} codeblocks, plain CRC OK {int(crc_ok.sum())}, "
            f"kernel == plain (6 iterations) on {int(same.sum())}, early stop == "
            f"plain on {int(same_es[crc_ok].sum())}/{int(crc_ok.sum())} CRC-OK ones, "
            f"iterations run {np.bincount(it_es, minlength=7).tolist()}")
        check(same.all(), "kernel hard bits differ from the plain decoder")
        check(same_es[crc_ok].all(), "early-stop bits differ on a CRC-OK codeblock")
        check((np.asarray(it) == 6).all(), "fixed-budget decode stopped early")


@phase("e served path (du_low_sim)")
def served_phase():
    sys.path.insert(0, os.path.join(ROOT, "apps"))
    import du_low_sim

    rc = du_low_sim.main(["--config", os.path.join(ROOT, "configs", "cell_100mhz_4x4.yml"),
                          "--ues", "2", "--slots", "4", "--strict"])
    check(rc == 0, f"du_low_sim exited {rc}")


@phase("f golden vectors on the card")
def golden_phase(jnp, np):
    sys.path.insert(0, os.path.join(ROOT, "tests", "vectors"))
    import conftest as vec
    import test_golden_ldpc_decoder as g_ldpc
    import test_golden_pdsch_processor as g_pdsch
    import test_golden_phy as g_phy
    import test_golden_pusch_processor as g_pusch

    from srsran_project_tpu.ops.ldpc import decoder, decoder_cuda
    from srsran_project_tpu.support.file_vector import read_vector

    for fn in (g_pdsch.test_pdsch_processor_golden, g_pusch.test_pusch_processor_golden,
               g_ldpc.test_ldpc_decoder_i8_golden, g_ldpc.test_ldpc_decoder_i8_recovers_message,
               g_phy.test_ofdm_modulator_golden, g_phy.test_ofdm_demodulator_golden):
        fn()
        log(f"{fn.__module__}.{fn.__name__}: ok")
    # The GPU kernel on the golden LDPC inputs: equal to the plain float
    # decoder on every case, and the message recovered at >= 6 dB.
    cases = vec.load_suite("ldpc_decoder")
    for case in cases:
        llrs = read_vector(vec.suite_path("ldpc_decoder", case["llrs"]), "i8")
        msg = read_vector(vec.suite_path("ldpc_decoder", case["message"]), "u8")
        x = jnp.asarray(llrs)[None]
        got = np.asarray(decoder_cuda.decode(x, case["bg"], case["ls"],
                                             case["max_iter"])[0])[0]
        ref = np.asarray(decoder.decode(x.astype(jnp.float32), case["bg"], case["ls"],
                                        case["max_iter"])[0])[0]
        check((got == ref).all(), f"kernel != plain decoder on {case}")
        if case["snr_db"] >= 6.0:
            check((got == msg).all(), f"kernel did not recover the message: {case}")
    log(f"GPU LDPC kernel on {len(cases)} golden cases: equal to the plain decoder")


def one_card(jax) -> None:
    import jax.numpy as jnp
    import numpy as np

    from srsran_project_tpu.models import cell as cell_mod
    from srsran_project_tpu.ops.ldpc import decoder_cuda

    t0 = time.perf_counter()
    decoder_cuda.build()
    log(f"GPU LDPC kernel library ready ({time.perf_counter() - t0:.1f} s)")
    cfg = cell_mod.CellConfig()
    log(f"flagship: {cfg.nof_rb} PRB, {cfg.nof_ports}x{cfg.nof_layers}, "
        f"tbs={cfg.tbs}, {cfg.pusch_cfg.sch.seg.nof_codeblocks} codeblocks")
    tb, rnti, w, iq, iq_rx = flagship_phase(jax, jnp, np, cell_mod, cfg)
    cpu_phase(jax, jnp, np, cell_mod, cfg, tb, rnti, w, iq, iq_rx)
    kernel_phase(jax, jnp, np, cell_mod, cfg, iq, rnti)
    served_phase()
    golden_phase(jnp, np)


@phase("four cards: dryrun_multichip(4)")
def four_cards() -> None:
    sys.path.insert(0, ROOT)
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    plats = os.environ.get("JAX_PLATFORMS")
    import jax

    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")  # phase (c)
    want = 4 if args.four_cards else 1
    try:
        devs = device_phase(want)
        if args.four_cards:
            four_cards()
        else:
            one_card(jax)
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        log("FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
