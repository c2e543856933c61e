#!/usr/bin/env python3
"""du_low_sim — standalone DU-low (upper PHY) application over simulated RF.

Counterpart of the reference's apps/du_low (standalone split-6 PHY,
apps/du_low/du_low.cpp:62) combined with its ZMQ simulated radio: drives
the slot pipeline from a YAML config, exchanging IQ either in-process
(loopback channel emulator) or over the native UDP IQ transport with an
external UE/RU emulator.

Usage:
  python apps/du_low_sim.py --config configs/cell_20mhz.yml --slots 20
  python apps/du_low_sim.py --slots 10 --set cell.nof_rb=52 --trace /tmp/t.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="YAML cell config")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. cell.nof_rb=52")
    ap.add_argument("--slots", type=int, default=10)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--channel", default="tdla", choices=["single", "tdla", "tdlb", "tdlc"])
    ap.add_argument("--trace", default=None, help="write Chrome trace JSON here")
    ap.add_argument("--ues", type=int, default=0,
                    help="multi-UE scheduler mode: number of UEs (0 = single full-band UE)")
    ap.add_argument("--cells", type=int, default=1,
                    help="scheduler-mode cell count: one per-cell scheduler "
                         "+ PHY + FAPI stream each (reference "
                         "cell_scheduler-per-cell architecture)")
    ap.add_argument("--tdd", action="store_true", help="7D1S2U TDD pattern (scheduler mode)")
    ap.add_argument("--policy", default="rr", choices=["rr", "qos"])
    ap.add_argument("--common", action="store_true",
                    help="schedule common channels too (SSB/SIB1/paging/CSI-RS/"
                         "PRACH occasions via CellScheduler)")
    ap.add_argument("--pcap", default=None,
                    help="write MAC-NR pcap of scheduler-mode TBs here")
    ap.add_argument("--metrics-json", action="store_true", help="print metrics JSON line")
    ap.add_argument("--metrics-interval-slots", type=int, default=0,
                    help="emit a periodic metrics JSON line every N slots "
                         "(the reference's periodic_metrics_report_controller)")
    ap.add_argument("--remote-port", type=int, default=None,
                    help="serve the remote-control WebSocket endpoint here "
                         "(reference apps/services/remote_control; 0 = ephemeral)")
    ap.add_argument("--ru", default="none", choices=["none", "generic", "ofh"],
                    help="route DL/UL through the RU abstraction layer: "
                         "'generic' OFDM-modulates to baseband, loops it back "
                         "as uplink and demodulates through RuGeneric; 'ofh' "
                         "frames the grid as paced eCPRI C/U-plane messages "
                         "(T1a windows against a per-symbol OTA clock, BFP "
                         "compression) and loops the wire back as the RU's "
                         "uplink")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--dump-config", action="store_true")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero unless every UL CRC passed")
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from srsran_project_tpu.fapi import messages as fapi
    from srsran_project_tpu.models import cell as cell_mod
    from srsran_project_tpu.phy import channel_emulator as chem
    from srsran_project_tpu.phy import pusch as pusch_mod
    from srsran_project_tpu.phy.slot_pipeline import SlotPipeline
    from srsran_project_tpu.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu.ran.constants import SubcarrierSpacing
    from srsran_project_tpu.ran.slot_point import SlotPoint
    from srsran_project_tpu.support import config as cfg_mod
    from srsran_project_tpu.support import staging, tracing
    from srsran_project_tpu.support.metrics import collector

    overrides = {}
    for s in args.set:
        k, v = s.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    du_cfg = cfg_mod.load_config(args.config, overrides)
    if args.dump_config:
        print(cfg_mod.dump_config(du_cfg))
        return 0
    cell = cfg_mod.to_cell_config(du_cfg)

    if args.trace:
        tracing.enable_all()

    phy = UpperPhy(UpperPhyConfig(nof_ports=cell.nof_ports,
                                  nof_grid_sc=cell.nof_sc))
    pipe = SlotPipeline(phy, slot_duration_s=500e-6, depth=du_cfg.expert_phy.max_processing_delay_slots)
    ch_cfg = chem.ChannelConfig(profile=args.channel, sinr_db=args.snr_db,
                                nof_tx_ports=cell.nof_ports, nof_rx_ports=cell.nof_ports,
                                nof_sc=cell.nof_sc, scs=cell.scs)

    rng = np.random.default_rng(0)
    w = np.eye(cell.nof_layers, cell.nof_ports, dtype=np.complex64)
    key = jax.random.PRNGKey(1)
    crc_ok = 0

    print(f"# cell: {cell.nof_rb} PRB, {cell.nof_ports}x{cell.nof_layers}, "
          f"tbs={cell.tbs} bits, channel={args.channel}@{args.snr_db}dB", file=sys.stderr)

    ru = None
    ru_rx = {}

    class _RuCollector:
        def on_new_uplink_symbol(self, context, grid_, is_valid):
            if is_valid:
                ru_rx[context.slot] = grid_

        def on_new_prach_window_data(self, context, buffer):
            pass

    def _add_awgn(x, snr_db):
        """AWGN at snr_db against the OCCUPIED-sample power (zero REs of a
        partially-filled grid must not dilute the measurement)."""
        m = np.abs(x) ** 2
        sig = float(m[m > 0].mean()) if (m > 0).any() else 1.0
        nstd = np.sqrt(sig * 10.0 ** (-snr_db / 10.0) / 2.0)
        return x + nstd * (rng.standard_normal(x.shape)
                           + 1j * rng.standard_normal(x.shape)
                           ).astype(np.complex64)

    if args.ru == "generic":
        # DL grid -> RU (OFDM modulate -> baseband) -> loopback -> RU
        # (demodulate) -> upper PHY: the reference's ru_generic role with
        # the sample stream looped in-process (ZMQ-sim analogue).
        from srsran_project_tpu.ru import (ResourceGridContext, RuGeneric,
                                           RuGenericConfig)

        ru_tx = {}
        ru = RuGeneric(RuGenericConfig(scs=SubcarrierSpacing(cell.scs),
                                       dft_size=cell.dft_size,
                                       nof_rb=cell.nof_rb),
                       _RuCollector(),
                       transmit_cb=lambda s, x: ru_tx.__setitem__(s, x))
        ru.start()
        ru_ctx = {"tx": ru_tx, "rx": ru_rx,
                  "ResourceGridContext": ResourceGridContext}
    elif args.ru == "ofh":
        # DL grid -> paced OFH transmitter (C/U-plane in their T1a windows
        # against the OTA symbol clock) -> wire loopback -> OFH receiver ->
        # UL grid: the lib/ru/ofh pipeline with the Ethernet flow looped
        # in-process.  DL data is submitted one slot ahead of air time, as
        # a DU would.
        from srsran_project_tpu.ru import (ResourceGridContext, RuOfh,
                                           RuOfhConfig)

        wire = []
        ru = RuOfh(RuOfhConfig(scs=SubcarrierSpacing(cell.scs),
                               nof_prb=cell.nof_rb,
                               nof_ports=cell.nof_ports),
                   _RuCollector(), send_frame=wire.append)
        ru.start()
        ru_ctx = {"wire": wire, "rx": ru_rx,
                  "ResourceGridContext": ResourceGridContext}

    def run_slot(i: int) -> bool:
        nonlocal key
        slot = SlotPoint.from_sfn_slot(SubcarrierSpacing(cell.scs), i // 20, i % 20)
        tb = rng.integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
        dl = fapi.DlTtiRequest(slot=slot, pdsch=[fapi.DlPdschPdu(cell.pdsch_cfg, 0x4601, w, 0)])
        with tracing.l1_tracer.span(f"dl_slot_{i}"):
            grid = phy.process_dl_tti(dl, fapi.TxDataRequest(slot=slot, payloads=[tb]))
        key, sub = jax.random.split(key)
        if args.ru == "ofh":
            Ctx = ru_ctx["ResourceGridContext"]
            air = slot + 1  # DL data arrives one slot ahead of air time
            ru.ota_tick(slot)
            ru.handle_new_uplink_slot(Ctx(slot=air))
            ru.handle_dl_data(Ctx(slot=air), np.asarray(grid))
            # Tick the OTA clock through this slot + the air slot; every
            # paced frame dispatches inside its window and loops back as
            # the RU's uplink on the same eAxC map.
            for tick_slot, sym in [(slot, sy) for sy in range(14)] +                                   [(air, sy) for sy in range(14)]:
                ru.ota_tick(tick_slot, sym)
                while ru_ctx["wire"]:
                    f = ru_ctx["wire"].pop(0)
                    if f[1] == 0x00:  # U-plane
                        ru.push_uplane_frame(f)
            rx = np.asarray(ru_ctx["rx"].pop(air))
            nstd = np.sqrt(float(np.mean(np.abs(rx) ** 2))
                           * 10.0 ** (-args.snr_db / 10.0) / 2.0)
            rx = rx + nstd * (rng.standard_normal(rx.shape)
                              + 1j * rng.standard_normal(rx.shape)
                              ).astype(np.complex64)
            rx_grid = jax.device_put(rx.astype(np.complex64))
        elif ru is not None:
            Ctx = ru_ctx["ResourceGridContext"]
            ru.handle_dl_data(Ctx(slot=slot), np.asarray(grid))
            ru.handle_new_uplink_slot(Ctx(slot=slot))
            # Modulate + transmit; loop the baseband back with AWGN at the
            # configured SNR, demodulate through the RU's uplink plane.
            ru.advance_slot(slot)
            samples = _add_awgn(np.asarray(ru_ctx["tx"].pop(slot)),
                                args.snr_db)
            ru.push_ul_samples(slot, samples)
            ru.handle_new_uplink_slot(Ctx(slot=slot))
            ru.advance_slot(slot)
            rx_grid = jax.device_put(ru_ctx["rx"].pop(slot))
        else:
            rx_grid, _, _ = chem.apply_channel(grid, sub, ch_cfg)
        ul = fapi.UlTtiRequest(slot=slot, pusch=[fapi.UlPuschPdu(cell.pusch_cfg, 0x4601)])
        with tracing.l1_tracer.span(f"ul_slot_{i}"):
            res = phy.process_ul_tti(ul, rx_grid)
        return res.crc[0].tb_crc_ok

    if args.ues > 0 and args.cells > 1:
        # Multi-cell scheduler mode (reference cell_scheduler.cpp:92 — one
        # scheduler per cell): N cells, each with its own carrier, PHY
        # instance, channel and per-slot FAPI stream; UEs attach
        # round-robin across cells and are scheduled only on their serving
        # cell.  Per-cell metrics print at the end.
        from srsran_project_tpu.l2sim.multi_cell import MultiCellScheduler
        from srsran_project_tpu.l2sim.scheduler import SchedulerConfig

        cell_ids = list(range(args.cells))
        msched = MultiCellScheduler({cid: SchedulerConfig(
            nof_grid_sc=cell.nof_sc, nof_rb=cell.nof_rb,
            max_ues_per_slot=4, nof_layers=1, nof_ports=cell.nof_ports,
            policy=args.policy) for cid in cell_ids})
        for i in range(args.ues):
            msched.add_ue(0x100 + i, cell_ids[i % args.cells], mcs=10)
        phys = {cid: UpperPhy(UpperPhyConfig(
            nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc))
            for cid in cell_ids}
        t_start = time.monotonic()
        crc_ok = nof_grants = 0
        with staging.sync_stages():
            first = True
            for i in range(args.slots):
                slot = SlotPoint.from_sfn_slot(
                    SubcarrierSpacing(cell.scs), i // 20, i % 20)
                streams = msched.run_slot(slot, rng)
                for cid, (dl, txd, ulr, grants) in streams.items():
                    if not dl.pdsch:
                        continue
                    grid = phys[cid].process_dl_tti(dl, txd)
                    key, sub = jax.random.split(key)
                    rx_grid, _, _ = chem.apply_channel(grid, sub, ch_cfg)
                    res = phys[cid].process_ul_tti(ulr, rx_grid)
                    msched.handle_results(cid, res)
                    crc_ok += sum(c.tb_crc_ok for c in res.crc)
                    nof_grants += len(res.crc)
                if first:
                    first = False
                    staging._SYNC = False
        elapsed = time.monotonic() - t_start
        for cid, mrep in msched.metrics_report().items():
            print(f"# cell {cid}: {mrep}", file=sys.stderr)
        print(f"# multi-cell mode: {args.cells} cells, {args.ues} UEs, "
              f"{nof_grants} grants, {crc_ok} CRC OK in {elapsed:.2f}s",
              file=sys.stderr)
        bler = 1.0 - crc_ok / max(nof_grants, 1)
        if args.metrics_json:
            print(json.dumps({"cells": msched.metrics_report(),
                              "slots": args.slots, "bler": bler}))
        return _exit_code(bler, nof_grants, args.strict)

    if args.ues > 0:
        # Scheduler-driven multi-UE mode: RR/QoS policy + HARQ lifecycle.
        from srsran_project_tpu.l2sim.scheduler import RoundRobinScheduler, SchedulerConfig
        from srsran_project_tpu.ran.tdd import PATTERN_7D2U

        sc = SchedulerConfig(nof_grid_sc=cell.nof_sc, nof_rb=cell.nof_rb,
                             max_ues_per_slot=min(args.ues, 4),
                             nof_layers=1, nof_ports=cell.nof_ports,
                             tdd_pattern=PATTERN_7D2U if args.tdd else None,
                             policy=args.policy)
        sched = RoundRobinScheduler(sc)
        for i in range(args.ues):
            sched.add_ue(0x100 + i, mcs=10)
        ue_sched = sched
        if args.common:
            from srsran_project_tpu.l2sim.common_scheduling import (
                CellScheduler, CommonSchedulingConfig)
            sched = CellScheduler(CommonSchedulingConfig(
                nof_rb=cell.nof_rb, nof_grid_sc=cell.nof_sc), ue_sched)
            sched.ues = ue_sched.ues  # report/harq access passthrough
            sched.handle_results = ue_sched.handle_results
            sched.report = ue_sched.report
        # Periodic metrics reports: a TimerManager ticked once per slot
        # re-arms itself (reference periodic_metrics_report_controller).
        from srsran_project_tpu.support.timers import TimerManager
        tm = TimerManager()
        # Remote control endpoint (reference remote_server.cpp): JSON
        # commands over WebSocket; subscribed clients get the periodic
        # metrics lines; "quit" stops the slot loop.
        import threading
        stop_flag = threading.Event()
        remote = None
        if args.remote_port is not None:
            from srsran_project_tpu.support.remote_server import RemoteServer
            remote = RemoteServer(
                "127.0.0.1", args.remote_port,
                commands={"metrics": lambda msg: {"report": sched.report()}},
                on_quit=stop_flag.set)
            remote.start()
            print(f"# remote control: ws://127.0.0.1:{remote.port}",
                  file=sys.stderr)
        if args.metrics_interval_slots > 0:
            report_timer = tm.create_timer()

            def _periodic_report():
                line = json.dumps({"slot": tm.now, "type": "periodic",
                                   **{k: v for k, v in sched.report().items()}})
                print(line)
                if remote is not None:
                    remote.broadcast_metrics(line)
                report_timer.run()

            report_timer.set(args.metrics_interval_slots, _periodic_report)
        pcap_w = None
        if args.pcap:
            from srsran_project_tpu.support.pcap import (
                DIRECTION_DOWNLINK, MacNrPcapWriter)
            pcap_w = MacNrPcapWriter(args.pcap)
        t_start = time.monotonic()
        nof_grants = 0
        with staging.sync_stages():
            first = True
            for i in range(args.slots):
                if stop_flag.is_set():  # remote "quit"
                    break
                slot = SlotPoint.from_sfn_slot(SubcarrierSpacing(cell.scs), i // 20, i % 20)
                tm.tick()
                dl, txd, ulr, grants = sched.run_slot(slot, rng)
                rx_grid = None
                if dl.pdsch:
                    if pcap_w is not None:
                        from srsran_project_tpu.support.pcap import DIRECTION_DOWNLINK
                        for pdu, tb in zip(dl.pdsch, txd.payloads):
                            pcap_w.write_pdu(np.packbits(tb).tobytes(),
                                             rnti=pdu.rnti,
                                             direction=DIRECTION_DOWNLINK,
                                             sfn=slot.sfn, slot=slot.slot_in_frame)
                    grid = phy.process_dl_tti(dl, txd)
                    key, sub = jax.random.split(key)
                    rx_grid, _, _ = chem.apply_channel(grid, sub, ch_cfg)
                if ulr.pusch:
                    if rx_grid is None:
                        # TDD UL-only slot: synthesize the UE transmissions
                        # (no DL loopback grid to reuse).
                        import jax.numpy as jnp
                        tx = jnp.zeros((cell.nof_ports, 14, cell.nof_sc),
                                       dtype=jnp.complex64)
                        for pdu in ulr.pusch:
                            tb = sched.ues[pdu.rnti].harqs[pdu.harq_id].tb
                            sub_g = pusch_mod.transmit(
                                jnp.asarray(tb), np.uint32(pdu.rnti), pdu.config)
                            off = (pdu.first_rb or 0) * 12
                            tx = tx.at[:, :, off:off + sub_g.shape[2]].add(sub_g)
                        key, sub = jax.random.split(key)
                        rx_grid, _, _ = chem.apply_channel(tx, sub, ch_cfg)
                    res = phy.process_ul_tti(ulr, rx_grid)
                    sched.handle_results(res)
                    crc_ok += sum(c.tb_crc_ok for c in res.crc)
                    nof_grants += len(res.crc)
                if first:
                    first = False
                    staging._SYNC = False  # steady state after first slot
        elapsed = time.monotonic() - t_start
        if remote is not None:
            remote.stop()
        if pcap_w is not None:
            pcap_w.close()
            print(f"# pcap: {pcap_w.nof_packets} MAC PDUs -> {args.pcap}",
                  file=sys.stderr)
        if args.common:
            print(f"# common channels: {sched.counters}", file=sys.stderr)
        rep = sched.report()
        ul_mbps = sum(v["ul_bits_ok"] for v in rep.values()) / elapsed / 1e6
        print(f"# scheduler mode: {args.ues} UEs, {nof_grants} grants, "
              f"{crc_ok} CRC OK, {ul_mbps:.1f} Mbps UL", file=sys.stderr)
        bler = 1.0 - crc_ok / max(nof_grants, 1)
        print(f"# {args.slots} slots in {elapsed:.2f}s, BLER={bler:.3f}", file=sys.stderr)
        if args.metrics_json:
            print(collector.report_json())
        if args.trace:
            tracing.l1_tracer.write(args.trace)
        return _exit_code(bler, nof_grants, args.strict)

    t_start = time.monotonic()
    with staging.sync_stages():  # first slot compiles sequentially
        crc_ok += int(run_slot(0))
    for i in range(1, args.slots):
        crc_ok += int(run_slot(i))
    elapsed = time.monotonic() - t_start

    bler = 1.0 - crc_ok / args.slots
    print(f"# {args.slots} slots in {elapsed:.2f}s "
          f"({args.slots/elapsed:.1f} slot-pairs/s), BLER={bler:.3f}", file=sys.stderr)
    if args.metrics_json:
        print(collector.report_json())
    if args.trace:
        tracing.l1_tracer.write(args.trace)
    return _exit_code(bler, args.slots, args.strict)


def _exit_code(bler: float, nof_grants: int, strict: bool) -> int:
    """0 unless every UL TB failed, or (strict) any failed or none ran."""
    if strict:
        return 0 if bler == 0.0 and nof_grants > 0 else 1
    return 0 if bler < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
