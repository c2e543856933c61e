"""Full-stack e2e: GTP-U -> CU-UP(SDAP/PDCP) -> F1-U -> DU(RLC/MAC/sched)
-> PHY (PDSCH encode -> fading channel -> PUSCH decode) -> MAC/RLC ->
PDCP -> SDAP -> IP, both directions.

The framework analogue of the reference's e2e ping test (SURVEY.md
section 4 tier 4: gnb + UE over ZMQ RF): every byte crosses the real
LDPC/modulation/OFDM-grid signal path on the (virtual CPU) device mesh via
the scheduler's loopback grant pairing (PDSCH grid decoded by the PUSCH
chain, as in test_scheduler_sim).
"""

import jax
import numpy as np

from srsran_project_tpu.fapi import messages as fapi
from srsran_project_tpu.l2 import cu_up_sim, du_high_sim, gtpu, nru
from srsran_project_tpu.l2sim.scheduler import SchedulerConfig
from srsran_project_tpu.phy import channel_emulator as chem
from srsran_project_tpu.phy.upper_phy import UpperPhy, UpperPhyConfig
from srsran_project_tpu.ran.constants import SubcarrierSpacing
from srsran_project_tpu.ran.slot_point import SlotPoint

from test_du_cu_split import UeSim


def _slot(i):
    return SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, i // 20, i % 20)


def test_ip_packets_over_phy():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    core_rx = []

    du = du_high_sim.DuHighSim(SchedulerConfig(nof_rb=48, max_ues_per_slot=1))
    cu = cu_up_sim.CuUpSim(ue_id=1, ngu_tx=core_rx.append)
    ue = UeSim(rnti=0x4601)
    du_ue = du.add_ue(0x4601, mcs=6, on_rx_sdu=lambda pp: cu.rx_f1u_ul(1, pp))
    dl_rlc = du_ue.bearers[4].entity
    cu.setup_bearer(drb_id=1, qfi=9, teid_dl=0x10, teid_ul=0x20,
                    f1u_tx=lambda fr: dl_rlc.tx_sdu(nru.decode_dl_user_data(fr).payload))

    # the scheduler pulls DL TBs from the DU MAC assembler
    du.scheduler.tb_source = du.build_dl_tb

    phy = UpperPhy(UpperPhyConfig(nof_ports=1))
    ch = chem.ChannelConfig(profile="single", sinr_db=25.0, nof_sc=624)

    dl_packets = [bytes([i]) * int(rng.integers(60, 400)) for i in range(5)]
    ul_packets = [bytes([0xA0 | i]) * int(rng.integers(60, 300)) for i in range(4)]
    for p in dl_packets:
        cu.rx_ngu(gtpu.encode_gpdu(teid=0x10, payload=p, qfi=9))

    for i in range(24):
        if i < len(ul_packets):
            ue.send_ul(ul_packets[i])
        dl, tx, ul, grants = du.scheduler.run_slot(_slot(i), rng)
        # DL leg: PDSCH through the fading channel, decoded by the PUSCH
        # chain (loopback pairing), delivering the MAC TB to the UE.
        grid = phy.process_dl_tti(dl, tx)
        key, sub = jax.random.split(key)
        rx, _, _ = chem.apply_channel(grid, sub, ch)
        res = phy.process_ul_tti(ul, rx)
        du.scheduler.handle_results(res)
        for rxd in res.rx_data:
            ue.handle_dl_tb(np.asarray(rxd.payload))
        # UL leg: UE MAC TB rides the same signal path back
        if grants:
            _, _, tbs = grants[0]
            ul_tb = ue.build_ul_tb(tbs)
            dl2 = fapi.DlTtiRequest(slot=dl.slot, pdsch=dl.pdsch)
            tx2 = fapi.TxDataRequest(slot=dl.slot, payloads=[ul_tb])
            grid2 = phy.process_dl_tti(dl2, tx2)
            key, sub = jax.random.split(key)
            rx2, _, _ = chem.apply_channel(grid2, sub, ch)
            res2 = phy.process_ul_tti(ul, rx2)
            for rxd in res2.rx_data:
                du.handle_ul_tb(0x4601, np.asarray(rxd.payload))
        du.exchange_am_status(0x4601, 4, ue.rlc)
        cu.tick(i)
        ue.pdcp.tick(i)
        if len(ue.delivered) == len(dl_packets) and len(core_rx) == len(ul_packets):
            break

    assert [s for _, s in ue.delivered] == dl_packets
    assert [gtpu.decode(x).payload for x in core_rx] == ul_packets
