"""Flagship end-to-end cell model: full-slot PDSCH encode (DL) and PUSCH
decode (UL) including OFDM, for one static cell configuration.

This is the equivalent of wiring the reference's upper+lower PHY for one
carrier (upper_phy_impl + ofdm modulator: SURVEY.md §3.3/§3.4 call stacks):
encode_slot: TB bits -> PDSCH grid -> OFDM IQ samples;
decode_slot: IQ samples -> grid -> channel estimate -> equalize -> demap ->
LDPC decode -> TB + CRC.
"""

from __future__ import annotations

import dataclasses
import functools

import jax

from ..ops import ofdm
from ..ops.modulation import Modulation
from ..phy import pdsch, pusch
from ..phy.allocation import Allocation
from ..ran import tbs as tbs_mod
from ..ran.constants import NRE, CyclicPrefix, SubcarrierSpacing, min_dft_size
from ..support.staging import checkpoint


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Static cell parameters; defaults give the 100 MHz / 4x4 north star."""

    nof_rb: int = 273
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30
    cp: CyclicPrefix = CyclicPrefix.NORMAL
    nof_ports: int = 4
    nof_layers: int = 4
    modulation: Modulation = Modulation.QAM256
    target_code_rate: float = 948.0 / 1024.0
    f_center_hz: float = 3.5e9
    sym_start: int = 1
    sym_count: int = 13
    dmrs_symbols: tuple[int, ...] = (2,)
    slot_in_frame: int = 0
    # Expert PHY knobs (reference du_low_config.h), plumbed into pusch_cfg.
    nof_ldpc_iterations: int = 6
    ldpc_early_stop: bool = True
    equalizer: str = "mmse"
    sinr_method: str = "post_equalization"
    cfo_compensation: bool = False
    llr_range_limit: float = 20.0
    # Kernel selection (parity modes; see phy/pusch.py PuschConfig).
    demapper: str = "float"
    ldpc_decoder: str = "auto"
    noise_method: str = "second_difference"
    # Program granularity of the staged encode_slot/decode_slot: fused = 2
    # programs per direction (UL: demod+estimate+equalize+demap | LDPC;
    # DL: bit chain | gridmap+OFDM), so the host dispatches fewer programs
    # per slot.  False = 5/3-program stage mode.  encode_slot_fused /
    # decode_slot_fused are one program per direction either way.
    fuse_stages: bool = True

    @property
    def dft_size(self) -> int:
        return min_dft_size(self.nof_rb)

    @property
    def nof_sc(self) -> int:
        return self.nof_rb * NRE

    @functools.cached_property
    def alloc(self) -> Allocation:
        return Allocation(
            rb_start=0,
            rb_count=self.nof_rb,
            sym_start=self.sym_start,
            sym_count=self.sym_count,
            dmrs_symbols=self.dmrs_symbols,
        )

    @functools.cached_property
    def tbs(self) -> int:
        qm = int(self.modulation)
        n_dmrs_re = NRE * len(self.dmrs_symbols)  # type 1, 2 CDM groups w/o data
        return tbs_mod.calculate_tbs(
            self.nof_rb, self.sym_count, n_dmrs_re, self.target_code_rate, qm, self.nof_layers
        )

    @functools.cached_property
    def pdsch_cfg(self) -> pdsch.PdschConfig:
        return pdsch.PdschConfig(
            tbs=self.tbs,
            target_code_rate=self.target_code_rate,
            modulation=self.modulation,
            alloc=self.alloc,
            nof_layers=self.nof_layers,
            nof_ports=self.nof_ports,
            nof_grid_symbols=14,
            nof_grid_sc=self.nof_sc,
            slot_in_frame=self.slot_in_frame,
        )

    @functools.cached_property
    def pusch_cfg(self) -> pusch.PuschConfig:
        return pusch.PuschConfig(
            tbs=self.tbs,
            target_code_rate=self.target_code_rate,
            modulation=self.modulation,
            alloc=self.alloc,
            nof_layers=self.nof_layers,
            nof_rx_ports=self.nof_ports,
            nof_grid_symbols=14,
            nof_grid_sc=self.nof_sc,
            scs_khz=15 << int(self.scs),
            slot_in_frame=self.slot_in_frame,
            nof_ldpc_iterations=self.nof_ldpc_iterations,
            ldpc_early_stop=self.ldpc_early_stop,
            equalizer=self.equalizer,
            sinr_method=self.sinr_method,
            cfo_compensation=self.cfo_compensation,
            llr_range_limit=self.llr_range_limit,
            demapper=self.demapper,
            ldpc_decoder=self.ldpc_decoder,
            noise_method=self.noise_method,
        )


def tiny_cell(nof_rb: int = 6, nof_ports: int = 1) -> CellConfig:
    """A small cell for compile checks and virtual-mesh dry runs."""
    return CellConfig(
        nof_rb=nof_rb,
        nof_ports=nof_ports,
        nof_layers=nof_ports,
        modulation=Modulation.QPSK,
        target_code_rate=0.3,
        f_center_hz=0.0,
    )


import functools as _functools

import jax.numpy as _jnp


@_functools.partial(jax.jit, static_argnames=("cfg",))
def _dl_back_program(cw: jax.Array, precoding: jax.Array, cfg: CellConfig):
    """Grid mapping + OFDM modulation as ONE compiled program."""
    grid = pdsch._grid_chain(cw, precoding, cfg.pdsch_cfg)
    return ofdm.modulate_slot(grid, cfg.scs, cfg.dft_size, cfg.cp, 0,
                              f_center_hz=cfg.f_center_hz)


@_functools.partial(jax.jit, static_argnames=("cfg",))
def _ul_front_program(iq: jax.Array, rnti: jax.Array, cfg: CellConfig):
    """OFDM demod + estimate + equalize + demap as ONE compiled program
    (everything except the LDPC decode)."""
    grid = ofdm.demodulate_slot(iq, cfg.nof_rb, cfg.scs, cfg.dft_size, cfg.cp,
                                0, f_center_hz=cfg.f_center_hz)
    return pusch._front_end(grid, rnti, cfg.pusch_cfg)


def encode_slot(tb_bits: jax.Array, rnti: jax.Array, precoding: jax.Array, cfg: CellConfig):
    """DL slot: TB payload -> baseband IQ (nof_ports, nof_samples).

    Stage-jitted (encode_slot_fused is the one-program twin): the bit
    chain is its own program; with cfg.fuse_stages the rest (grid map +
    OFDM) is one fused program (2 total), else three stage programs.
    """
    if cfg.fuse_stages:
        cw = checkpoint(pdsch._bit_chain(tb_bits, _jnp.asarray(rnti), cfg.pdsch_cfg))
        return _dl_back_program(cw, _jnp.asarray(precoding), cfg)
    grid = checkpoint(pdsch.process(tb_bits, rnti, precoding, cfg.pdsch_cfg))
    return ofdm.modulate_slot(
        grid,
        cfg.scs,
        cfg.dft_size,
        cfg.cp,
        0,
        f_center_hz=cfg.f_center_hz,
    )


def decode_slot(iq: jax.Array, rnti: jax.Array, cfg: CellConfig):
    """UL slot: baseband IQ (nof_rx_ports, nof_samples) -> decode results.

    With cfg.fuse_stages: 2 compiled programs (fused front end | LDPC);
    else 5 (demod/estimate/equalize/demap/LDPC)."""
    if cfg.fuse_stages:
        llr_i8, noise_var, snr_acc = checkpoint(
            _ul_front_program(iq, _jnp.asarray(rnti), cfg))
        return pusch.finish(llr_i8, noise_var, snr_acc, cfg.pusch_cfg)
    grid = checkpoint(
        ofdm.demodulate_slot(
            iq,
            cfg.nof_rb,
            cfg.scs,
            cfg.dft_size,
            cfg.cp,
            0,
            f_center_hz=cfg.f_center_hz,
        )
    )
    return pusch.process(grid, rnti, cfg.pusch_cfg)


@_functools.partial(jax.jit, static_argnames=("cfg",))
def encode_slot_fused(tb_bits: jax.Array, rnti: jax.Array,
                      precoding: jax.Array, cfg: CellConfig):
    """The WHOLE DL slot as ONE compiled program (bit chain + grid map +
    OFDM): one dispatch per slot, at the cost of a longer compile."""
    cw = pdsch._bit_chain(tb_bits, _jnp.asarray(rnti), cfg.pdsch_cfg)
    grid = pdsch._grid_chain(cw, precoding, cfg.pdsch_cfg)
    return ofdm.modulate_slot(grid, cfg.scs, cfg.dft_size, cfg.cp, 0,
                              f_center_hz=cfg.f_center_hz)


@_functools.partial(jax.jit, static_argnames=("cfg",))
def encode_slots_scan(tb_chunks: jax.Array, rnti_chunks: jax.Array,
                      precoding: jax.Array, cfg: CellConfig):
    """k*B DL slots in ONE compiled program: `lax.scan` over k chunks of a
    B-slot vmapped `encode_slot_fused` body.

    A scan re-uses ONE traced x-B body k times, so the program size and
    its compile time stay ~constant while a single dispatch covers k*B
    slots.

    tb_chunks: (k, B, A) uint8; rnti_chunks: (k, B) uint32;
    precoding: (nl, P).  Returns (k, B) float32 per-slot IQ energy — a
    checksum depending on every sample, so the encodes cannot be DCE'd,
    without materializing (k, B, P, ns) IQ in HBM."""

    def body(_, xs):
        tb_b, rnti_b = xs
        iq = jax.vmap(lambda t, r: encode_slot_fused(t, r, precoding, cfg))(
            tb_b, rnti_b)
        e = (_jnp.abs(iq.real) ** 2 + _jnp.abs(iq.imag) ** 2).sum(axis=(1, 2))
        return None, e

    _, energy = jax.lax.scan(body, None, (tb_chunks, rnti_chunks))
    return energy


@_functools.partial(jax.jit, static_argnames=("cfg",))
def decode_slots_scan(iq_chunks: jax.Array, rnti_chunks: jax.Array,
                      tb_expected: jax.Array, cfg: CellConfig):
    """k*B UL slot decodes in ONE compiled program (scan twin of
    `encode_slots_scan`; same dispatch-amortization rationale).

    iq_chunks: (k, B, P, ns) complex64; rnti_chunks: (k, B) uint32;
    tb_expected: (A,) uint8 — the transmitted payload, compared on device.
    Returns (crc_ok (k, B) int32, bit_errors (k, B) int32): exact
    transfer-safe verdicts for EVERY benched decode."""

    def body(_, xs):
        iq_b, rnti_b = xs
        out = jax.vmap(lambda x, r: decode_slot_fused(x, r, cfg))(iq_b, rnti_b)
        ok = out["tb_crc_ok"].astype(_jnp.int32)
        errs = (out["tb_bits"] != tb_expected[None]).astype(_jnp.int32).sum(axis=1)
        return None, (ok, errs)

    _, (ok, errs) = jax.lax.scan(body, None, (iq_chunks, rnti_chunks))
    return ok, errs


@_functools.partial(jax.jit, static_argnames=("cfg",))
def decode_slot_fused(iq: jax.Array, rnti: jax.Array, cfg: CellConfig):
    """The WHOLE UL slot as ONE compiled program: OFDM demod + estimate +
    equalize + demap + rate dematch + LDPC decode (the backend's decoder,
    support/platform.py) + desegment/CRC, in a single dispatch."""
    from ..phy.sch import decode_transport_block

    grid = ofdm.demodulate_slot(iq, cfg.nof_rb, cfg.scs, cfg.dft_size,
                                cfg.cp, 0, f_center_hz=cfg.f_center_hz)
    pc = cfg.pusch_cfg
    llr_i8, noise_var, snr_acc = pusch._front_end(grid, _jnp.asarray(rnti), pc)
    tb, ok, _harq = decode_transport_block(
        llr_i8, pc.sch, pc.nof_ldpc_iterations, None,
        early_stop=pc.ldpc_early_stop)
    return {
        "tb_bits": tb,
        "tb_crc_ok": ok,
        "noise_var": noise_var,
        "snr_db": 10.0 * _jnp.log10(_jnp.maximum(snr_acc, 1e-12)),
    }
