"""L2 protocol stack: MAC PDU codecs, RLC, PDCP, SDAP, GTP-U, security.

Scope-parity counterpart of the reference's lib/mac, lib/rlc, lib/pdcp,
lib/sdap, lib/gtpu, lib/security (SURVEY.md section 2.4) at
interface/simulator fidelity per SURVEY section 1: deterministic host-side
protocol logic (bytes in, bytes out) that frames the PHY's transport
blocks, so the framework can be driven end-to-end above FAPI.
"""
