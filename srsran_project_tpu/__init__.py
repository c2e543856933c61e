"""srsran_project_tpu — a JAX-native 5G NR baseband framework.

A brand-new implementation (JAX/XLA, with a CUDA LDPC kernel for the GPU) of the capabilities of the
srsRAN Project's PHY pipeline: OFDM modulation/demodulation, PDSCH/PUSCH
processing chains (CRC, LDPC, polar, rate matching, QAM soft (de)mapping,
scrambling), DM-RS channel estimation, MIMO equalization, and the surrounding
slot runtime, re-designed data-first for accelerators.

Subpackages
-----------
ran        3GPP NR constants and derived-parameter library (pure host math)
ops        numeric kernels (jnp, one CUDA kernel): crc, scrambling, ldpc, polar,
           modulation, ofdm, equalization, estimation
phy        channel processors (PDSCH/PUSCH/PDCCH/PUCCH/SSB/PRACH) built on ops
fapi       FAPI-shaped slot command schema (the L2<->L1 contract)
parallel   device meshes, shardings, multi-chip slot programs
support    test-vector IO, config, metrics, tracing
models     flagship end-to-end cell pipelines (encode_slot / decode_slot)
"""

__version__ = "0.1.0"
