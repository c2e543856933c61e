"""Upper PHY slot orchestration: FAPI requests in, grids/indications out.

Counterpart of the reference's downlink_processor_multi_executor_impl /
uplink_processor_impl / upper_phy_impl (SURVEY.md §2.1): where the
reference fans PDUs out over executor pools and finishes the grid through
notifier webs, here each slot is one sequence of jitted tensor programs
accumulating into a single device-resident grid — concurrency is array
batching, not threads.  HARQ soft-bit state is a device-resident buffer
pool keyed like the reference's trx_buffer_identifier (rnti, harq id).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..fapi import messages as fapi
from . import csi_rs as csi_rs_mod
from . import pdcch as pdcch_mod
from . import pdsch as pdsch_mod
from . import prach as prach_mod
from . import pucch as pucch_mod
from . import pucch_f2 as pucch_f2_mod
from . import pusch as pusch_mod
from . import srs as srs_mod
from . import ssb as ssb_mod


@dataclasses.dataclass
class UpperPhyConfig:
    nof_ports: int = 1
    nof_grid_symbols: int = 14
    nof_grid_sc: int = 624
    # Debug dump of received UL grids (reference: phy_rx_symbols_filename,
    # du_low_config.h:102-107): cbf16 binary, one file per call.
    rx_symbols_filename: str | None = None
    validate_requests: bool = False  # run fapi.validators on each request


class HarqBufferPool:
    """Device-resident soft-bit buffers keyed by (rnti, harq id).

    Mirrors rx_buffer_pool_impl (lib/phy/upper/rx_buffer_pool_impl.cpp):
    new_data resets, retransmissions combine inside the PUSCH decoder.
    """

    def __init__(self, max_buffers: int = 64):
        self.max_buffers = max_buffers
        self._buffers: dict[tuple[int, int], object] = {}

    def get(self, rnti: int, harq_id: int):
        return self._buffers.get((rnti, harq_id))

    def put(self, rnti: int, harq_id: int, buf) -> None:
        if len(self._buffers) >= self.max_buffers and (rnti, harq_id) not in self._buffers:
            self._buffers.pop(next(iter(self._buffers)))
        self._buffers[(rnti, harq_id)] = buf

    def release(self, rnti: int, harq_id: int) -> None:
        self._buffers.pop((rnti, harq_id), None)


class UpperPhy:
    """One cell's upper PHY."""

    def __init__(self, cfg: UpperPhyConfig):
        self.cfg = cfg
        self.harq_pool = HarqBufferPool()
        # PHY tap: observers called at stage boundaries with device arrays
        # (reference: upper_phy_rx_symbol_notifier / phy tap plugin points,
        # include/srsran/phy/upper/upper_phy_rx_symbol_notifier.h).  Each
        # entry is fn(event: str, slot, payload) where payload is the grid
        # or result object; observers must not mutate it.
        self._taps: list = []

    def add_tap(self, fn) -> None:
        """Register an observer for 'dl_grid' / 'ul_grid' / 'ul_results'."""
        self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        self._taps.remove(fn)

    def _notify(self, event: str, slot, payload) -> None:
        for fn in self._taps:
            fn(event, slot, payload)

    # ------------------------------------------------------------------
    # Downlink: DL_TTI.request + TX_Data.request -> resource grid
    # ------------------------------------------------------------------
    def process_dl_tti(
        self, request: fapi.DlTtiRequest, tx_data: fapi.TxDataRequest
    ) -> jnp.ndarray:
        cfg = self.cfg
        if cfg.validate_requests:
            from ..fapi.validators import validate_dl_tti

            validate_dl_tti(request, tx_data, cfg.nof_grid_sc)
        grid = jnp.zeros(
            (cfg.nof_ports, cfg.nof_grid_symbols, cfg.nof_grid_sc), jnp.complex64)
        # Equal-config compact PDUs batch into ONE device program per
        # config (pdsch.process_multi — the multi-UE DL slot as a batched
        # program, not a host loop; reference slot = PDU list).
        batched, singles = {}, []
        for pdu in request.pdsch:
            c = pdu.config
            # Group key normalizes crb_start (the scheduler bakes the PRB
            # offset into it; process_multi re-derives per-grant pilots
            # from first_rb).  Only crb_start == first_rb grants batch —
            # a crb_start=0 grant at first_rb!=0 would get its DM-RS Gold
            # index re-derived from the wrong CRB (ADVICE r3).
            if (pdu.first_rb is not None and not c.ptrs_enabled
                    and c.alloc.crb_start == pdu.first_rb):
                key = dataclasses.replace(
                    c, alloc=dataclasses.replace(c.alloc, crb_start=0))
                batched.setdefault(key, []).append(pdu)
            else:
                singles.append(pdu)
        for cfg_g, pdus in batched.items():
            if len(pdus) == 1:
                singles.extend(pdus)
                continue
            tbs = np.stack([np.asarray(tx_data.payloads[p.tb_index], np.uint8)
                            for p in pdus])
            rntis = np.asarray([p.rnti for p in pdus], np.uint32)
            offs = [p.first_rb for p in pdus]
            w = jax.device_put(np.stack(
                [np.asarray(p.precoding, np.complex64) for p in pdus]))
            grid = pdsch_mod.process_multi(tbs, rntis, offs, w, cfg_g, grid=grid)
        for pdu in singles:
            tb = jnp.asarray(tx_data.payloads[pdu.tb_index], jnp.uint8)
            sub = pdsch_mod.process(
                tb, jnp.uint32(pdu.rnti), jax.device_put(np.asarray(pdu.precoding, np.complex64)), pdu.config
            )
            if pdu.first_rb is None:
                grid = grid + sub
            else:
                # Compact-grid PDU: place at the granted PRB offset so all
                # equal-size grants share one compiled program.

                off = jnp.asarray(pdu.first_rb * 12, jnp.int32)
                window = jax.lax.dynamic_slice(
                    grid, (0, 0, off), (grid.shape[0], grid.shape[1], sub.shape[2])
                )
                grid = jax.lax.dynamic_update_slice(grid, window + sub, (0, 0, off))
        # All broadcast PDUs (PDCCH/SSB/CSI-RS) accumulate in ONE compiled
        # program (phy/dl_slot.py — the DL twin of the heterogeneous UL
        # slot program): control-heavy slots stay at a bounded dispatch
        # count regardless of PDU fan-out.
        from . import dl_slot as dl_slot_mod

        grid = dl_slot_mod.assemble_broadcast(grid, request, cfg)
        self._notify("dl_grid", request.slot, grid)
        return grid

    # ------------------------------------------------------------------
    # Uplink: UL_TTI.request + received grid -> indications
    # ------------------------------------------------------------------
    def process_ul_dci(self, request: "fapi.UlDciRequest",
                       grid: jnp.ndarray | None = None) -> jnp.ndarray:
        """Encode UL_DCI.request PDCCH PDUs onto a (new or given) DL grid."""
        cfg = self.cfg
        if grid is None:
            grid = jnp.zeros(
                (cfg.nof_ports, cfg.nof_grid_symbols, cfg.nof_grid_sc), jnp.complex64)
        for pdu in request.pdcch:
            g = pdcch_mod.process(
                jnp.asarray(pdu.payload, jnp.uint8), jnp.uint32(pdu.rnti), pdu.config)
            grid = grid.at[0].add(g)
        return grid

    def process_ul_tti(
        self,
        request: fapi.UlTtiRequest,
        rx_grid: jnp.ndarray,
        prach_fd: jnp.ndarray | None = None,
    ) -> fapi.SlotResults:
        res = fapi.SlotResults(slot=request.slot)
        if self.cfg.validate_requests:
            from ..fapi.validators import validate_ul_tti

            validate_ul_tti(request, self.cfg.nof_grid_sc)
        self._notify("ul_grid", request.slot, rx_grid)
        if self.cfg.rx_symbols_filename:
            from ..support import file_vector

            file_vector.write_vector(
                f"{self.cfg.rx_symbols_filename}.{request.slot.count}",
                np.asarray(rx_grid).reshape(-1),
                "cbf16",
            )
        # Heterogeneous multi-UE slot program (phy/ul_slot.py): ALL compact
        # PUSCH grants without UCI/PT-RS — mixed MCS/alloc widths and
        # retransmissions included — decode through ONE front-end program
        # plus per-(bg, Z) codeblock-batched LDPC decodes, with PUCCH F1
        # occasions folded into the same front-end program.  The per-PDU
        # path remains for UCI-on-PUSCH / PT-RS / non-compact grants
        # (reference slot shape: uplink_processor_impl.h:149's mixed PDU
        # repository).
        multi_outs: dict[int, dict] = {}
        f1_folded: dict[int, tuple] = {}
        f0_folded: dict[int, tuple] = {}
        f2_folded: dict[int, tuple] = {}
        # Round 5: UCI-on-PUSCH and PT-RS grants now fold into the slot
        # program (ul_slot handles them); only two-step CSI stays per-PDU.
        eligible = [
            i for i, pdu in enumerate(request.pusch)
            if (pdu.first_rb is not None
                and (pdu.config.uci is None
                     or pdu.config.uci.csi_report_cfg is None)
                and pdu.config.alloc.crb_start == pdu.first_rb)
        ]
        if len(eligible) >= 2:
            from . import ul_slot as ul_slot_mod

            slot_pdus = []
            for i in eligible:
                p = request.pusch[i]
                hb = (None if p.new_data
                      else self.harq_pool.get(p.rnti, p.harq_id))
                slot_pdus.append(ul_slot_mod.UlSlotPdu(
                    rnti=p.rnti, first_rb=p.first_rb, config=p.config,
                    harq_buffer=hb))
            f1_idx = [j for j, pp in enumerate(request.pucch)
                      if isinstance(pp.config, pucch_mod.PucchFormat1Config)]
            f1_cfgs = tuple(request.pucch[j].config for j in f1_idx)
            f0_idx = [j for j, pp in enumerate(request.pucch)
                      if isinstance(pp.config, pucch_mod.PucchFormat0Config)]
            f0_cfgs = tuple(request.pucch[j].config for j in f0_idx)
            f2_idx = [j for j, pp in enumerate(request.pucch)
                      if isinstance(pp.config, pucch_f2_mod.PucchFormat2Config)]
            f2_cfgs = tuple(request.pucch[j].config for j in f2_idx)
            if f2_cfgs:
                outs, f1_outs, f0_outs, f2_outs = ul_slot_mod.process_slot(
                    rx_grid, slot_pdus, f1_cfgs, f0_cfgs, f2_cfgs)
            else:
                outs, f1_outs, f0_outs = ul_slot_mod.process_slot(
                    rx_grid, slot_pdus, f1_cfgs, f0_cfgs)
                f2_outs = ()
            for i, out in zip(eligible, outs):
                multi_outs[i] = out
            for j, fo in zip(f1_idx, f1_outs):
                f1_folded[j] = fo
            for j, fo in zip(f0_idx, f0_outs):
                f0_folded[j] = fo
            for j, fo in zip(f2_idx, f2_outs):
                f2_folded[j] = fo
        for i, pdu in enumerate(request.pusch):
            if i in multi_outs:
                out = multi_outs[i]
            else:
                harq = None if pdu.new_data else self.harq_pool.get(pdu.rnti, pdu.harq_id)
                pdu_grid = rx_grid
                if pdu.first_rb is not None:

                    w = pdu.config.nof_grid_sc
                    pdu_grid = jax.lax.dynamic_slice(
                        rx_grid,
                        (0, 0, jnp.asarray(pdu.first_rb * 12, jnp.int32)),
                        (rx_grid.shape[0], rx_grid.shape[1], w),
                    )
                out = pusch_mod.process(pdu_grid, jnp.uint32(pdu.rnti), pdu.config, harq_buffer=harq)
            ok = bool(np.asarray(out["tb_crc_ok"]))
            if "harq_ack_bits" in out:
                res.uci.append(fapi.UciIndicationPdu(
                    pdu.rnti, np.asarray(out["harq_ack_bits"]),
                    bool(np.asarray(out["harq_ack_ok"])), 0.0))
            if "csi1_bits" in out:
                res.uci.append(fapi.UciIndicationPdu(
                    pdu.rnti, np.asarray(out["csi1_bits"]),
                    bool(np.asarray(out["csi1_ok"])), 0.0))
            if "csi2_bits" in out:
                res.uci.append(fapi.UciIndicationPdu(
                    pdu.rnti, np.asarray(out["csi2_bits"]),
                    bool(np.asarray(out["csi2_ok"])), 0.0))
            res.crc.append(fapi.CrcIndicationPdu(
                pdu.rnti, pdu.harq_id, ok,
                snr_db=float(np.asarray(out["snr_db"])),
                ta_s=(float(np.asarray(out["ta_s"]))
                      if "ta_s" in out else None)))
            if ok:
                res.rx_data.append(
                    fapi.RxDataIndicationPdu(pdu.rnti, pdu.harq_id, np.asarray(out["tb_bits"]))
                )
                self.harq_pool.release(pdu.rnti, pdu.harq_id)
            else:
                self.harq_pool.put(pdu.rnti, pdu.harq_id, out["harq_buffer"])
        for pdu_j, pdu in enumerate(request.pucch):
            c = pdu.config
            if isinstance(c, pucch_mod.PucchFormat0Config):
                if pdu_j in f0_folded:
                    val, metric = f0_folded[pdu_j]  # detected in the slot program
                else:
                    val, metric, _ = pucch_mod.format0_detect(rx_grid, c)
                # candidate index encodes HARQ bits; with an SR opportunity
                # the upper half of the candidate set means "SR positive" —
                # appended as a trailing bit in uci_bits.
                n_base = max(1, 1 << c.nof_harq_bits)
                harq_val = int(val) % n_base
                bits = [(harq_val >> i) & 1 for i in range(c.nof_harq_bits)]
                if c.sr_opportunity:
                    bits.append(1 if int(val) >= n_base else 0)
                res.uci.append(
                    fapi.UciIndicationPdu(
                        pdu.rnti, np.asarray(bits, np.uint8),
                        float(metric) > pucch_mod.F0_DTX_THRESHOLD, float(metric))
                )
            elif isinstance(c, pucch_mod.PucchFormat1Config):
                if pdu_j in f1_folded:
                    bits, metric = f1_folded[pdu_j]  # detected in the slot program
                else:
                    bits, _, metric = pucch_mod.format1_detect(rx_grid, c)
                res.uci.append(
                    fapi.UciIndicationPdu(
                        pdu.rnti, np.asarray(bits),
                        float(metric) > pucch_mod.F1_DTX_THRESHOLD, float(metric))
                )
            elif isinstance(c, pucch_f2_mod.PucchFormat2Config):
                if pdu_j in f2_folded:
                    bits, ok, snr = f2_folded[pdu_j]  # decoded in the slot program
                else:
                    bits, ok, snr = pucch_f2_mod.process(rx_grid, c)
                res.uci.append(
                    fapi.UciIndicationPdu(pdu.rnti, np.asarray(bits), bool(np.asarray(ok)), float(snr))
                )
            else:
                res.errors.append(fapi.ErrorIndication(request.slot, f"unsupported PUCCH {type(c)}"))
        for pdu in request.srs:
            est = srs_mod.estimate(rx_grid, pdu.config)
            snr = float(np.asarray(est["epre"]).mean() / max(float(np.asarray(est["noise_var"]).mean()), 1e-12))
            res.srs.append(
                fapi.SrsIndicationPdu(
                    pdu.rnti,
                    10.0 * np.log10(max(snr, 1e-12)),
                    float(np.asarray(est["phase_slope"]).mean()),
                    np.asarray(est["h"]),
                )
            )
        for pdu in request.prach:
            if prach_fd is None:
                res.errors.append(fapi.ErrorIndication(request.slot, "PRACH requested, no buffer"))
                continue
            out = prach_mod.detect(prach_fd, pdu.config)
            det = np.asarray(out["detected"])
            for idx in np.nonzero(det)[0]:
                res.rach.append(
                    fapi.RachIndicationPdu(
                        int(idx),
                        float(np.asarray(out["metric"])[idx]),
                        float(np.asarray(out["ta_samples"])[idx]),
                    )
                )
        self._notify("ul_results", request.slot, res)
        return res
