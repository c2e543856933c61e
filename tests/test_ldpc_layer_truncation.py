"""LBRM layer truncation (graphs.active_layers) and the decoder input
assembly, over rate-matching geometries.

With limited-buffer rate matching the check rows whose parity column lies
beyond n_cb never send a nonzero message to the data bits, so decoding
only the active rows is bit-exact for the message.  These tests pin that
claim for the plain decoder and for the GPU kernel's algorithm
(decoder_cuda.reference_model), and pin the circular-buffer load the
kernel does (punctured prefix, +-64 clamp, truncated width) at zero
iterations, where any misplaced LLR flips a hard decision.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from srsran_project_tpu.ops.ldpc import decoder as ldpc_decoder
from srsran_project_tpu.ops.ldpc import decoder_cuda, graphs
from srsran_project_tpu.ops.ldpc import rate_match as rm
from srsran_project_tpu.phy import sch as sch_mod
from srsran_project_tpu.phy.sch import SchConfig


def _llr_stream(cfg: SchConfig, seed: int = 0):
    """Noisy int8 LLRs of a random TB's rate-matched codeword."""
    rng = np.random.default_rng(seed)
    tb = jnp.asarray(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
    cw = np.asarray(sch_mod.encode_transport_block(tb, cfg))
    llr = (1.0 - 2.0 * cw.astype(np.float32)) * 14.0
    llr = llr + rng.normal(0.0, 4.0, size=llr.shape)
    return tb, jnp.asarray(np.clip(np.round(llr), -120, 120).astype(np.int8))


def _buffers(llrs, cfg: SchConfig):
    buf = sch_mod._dematch_stage(llrs, None, cfg)
    buf = buf.reshape((-1,) + buf.shape[-1:])
    return buf, buf.astype(jnp.float32)


def _plain_bits(llrs, cfg: SchConfig, iters: int, n_cb="cfg"):
    seg = cfg.seg
    _, flat = _buffers(llrs, cfg)
    n_cb = cfg.n_cb if n_cb == "cfg" else n_cb
    bits, _ = ldpc_decoder.decode(flat, seg.base_graph, seg.lifting_size, iters,
                                  n_cb=n_cb)
    return np.asarray(bits)


def _kernel_model_bits(llrs, cfg: SchConfig, iters: int):
    seg = cfg.seg
    buf, _ = _buffers(llrs, cfg)
    bits, _ = decoder_cuda.reference_model(np.asarray(buf), seg.base_graph,
                                           seg.lifting_size, iters, n_cb=cfg.n_cb)
    return bits


CASES = [
    # Single- and two-E-group splits, BG1 and BG2, rv != 0 and LBRM.
    pytest.param(dict(tbs=3000, target_code_rate=0.5, qm=4, nof_layers=1,
                      nof_total_bits=6000, rv=0, tbs_lbrm_bytes=None),
                 id="bg1-single-cb"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=0, tbs_lbrm_bytes=None),
                 id="bg1-two-cbs-two-e-groups"),
    pytest.param(dict(tbs=2000, target_code_rate=0.2, qm=2, nof_layers=1,
                      nof_total_bits=9000, rv=0, tbs_lbrm_bytes=None),
                 id="bg2-low-rate"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=2, tbs_lbrm_bytes=None),
                 id="bg1-rv2"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=0, tbs_lbrm_bytes=2000),
                 id="bg1-lbrm"),
]


@pytest.mark.parametrize("kw", CASES)
def test_truncated_decode_matches_full_graph(kw):
    """Plain decoder on the active rows == plain decoder on all rows, and
    the kernel's algorithm == both (4 iterations)."""
    cfg = SchConfig(**kw)
    _, llrs = _llr_stream(cfg)
    full = _plain_bits(llrs, cfg, 4, n_cb=None)
    np.testing.assert_array_equal(_plain_bits(llrs, cfg, 4), full)
    np.testing.assert_array_equal(_kernel_model_bits(llrs, cfg, 4), full)


def _position_llrs(cfg: SchConfig) -> jnp.ndarray:
    """Deterministic position-DEPENDENT LLRs: any permutation error in the
    buffer assembly flips hard decisions (a noisy-codeword comparison lets
    the decoder correct small misplacements)."""
    g = cfg.nof_total_bits
    v = (np.arange(g, dtype=np.int64) * 37 + 11) % 199 - 99
    v[v == 0] = 7
    return jnp.asarray(np.clip(v, -120, 120).astype(np.int8))


@pytest.mark.parametrize("kw", CASES)
def test_assembly_zero_iterations(kw):
    """iters=0 compares the loaded circular buffer's hard decisions."""
    cfg = SchConfig(**kw)
    llrs = _position_llrs(cfg)
    np.testing.assert_array_equal(_kernel_model_bits(llrs, cfg, 0),
                                  _plain_bits(llrs, cfg, 0))


def test_assembly_flagship_geometry():
    """The 100 MHz 4x4 flagship coding geometry (141 CBs, BG1 Z=384, LBRM
    n_cb=13595 -> 16 of 46 layers, two E-groups) at zero iterations."""
    from srsran_project_tpu.models import cell as cell_mod

    cfg = cell_mod.CellConfig().pusch_cfg.sch
    g = graphs.get_graph(cfg.seg.base_graph, cfg.seg.lifting_size)
    assert cfg.n_cb == 13595 and graphs.active_layers(g, cfg.n_cb) == 16
    llrs = _position_llrs(cfg)
    np.testing.assert_array_equal(_kernel_model_bits(llrs, cfg, 0),
                                  _plain_bits(llrs, cfg, 0))


def test_full_decode_crc_ok():
    """End-to-end: decode_transport_block recovers the TB with CRC OK."""
    cfg = SchConfig(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                    nof_total_bits=20032, rv=0, tbs_lbrm_bytes=2000)
    tb, llrs = _llr_stream(cfg, seed=3)
    tb_out, ok, _ = sch_mod.decode_transport_block(llrs, cfg, 6)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(tb_out), np.asarray(tb))


def test_batched_leading_dim():
    """Leading batch dims flow through dematch, decode and desegment."""
    cfg = SchConfig(tbs=3000, target_code_rate=0.5, qm=4, nof_layers=1,
                    nof_total_bits=6000, rv=0, tbs_lbrm_bytes=None)
    tb0, l0 = _llr_stream(cfg, seed=1)
    tb1, l1 = _llr_stream(cfg, seed=2)
    tb_out, ok, harq = sch_mod.decode_transport_block(jnp.stack([l0, l1]), cfg, 4)
    assert np.asarray(ok).all() and harq.shape[0] == 2
    np.testing.assert_array_equal(np.asarray(tb_out), np.stack([tb0, tb1]))


def test_repetition_geometry_decodes():
    """E above the usable buffer (repetition: the dematcher accumulates the
    repeated positions) decodes with CRC OK."""
    cfg = SchConfig(tbs=300, target_code_rate=0.1, qm=2, nof_layers=1,
                    nof_total_bits=4000, rv=0, tbs_lbrm_bytes=None)
    usable = sum(ln for _, ln in rm._valid_runs(
        cfg.seg.base_graph, cfg.seg.lifting_size,
        cfg.seg.nof_payload_bits_per_cb, 0, cfg.seg.full_codeword_bits))
    assert max(cfg.cb_e_bits) > usable
    tb, llrs = _llr_stream(cfg, seed=4)
    tb_out, ok, _ = sch_mod.decode_transport_block(llrs, cfg, 6)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(tb_out), np.asarray(tb))
