#!/usr/bin/env python3
"""Multi-host scaling artifact: codeblock-parallel decode over a REAL
process boundary (BASELINE north-star row "scaling efficiency >=80%
going 1 host -> 2 hosts").

Two OS processes, 4 virtual CPU devices each, stitched by
jax.distributed into one (host=2, dp=4) mesh — the "host" axis
collectives cross the (loopback) DCN exactly as a pod-to-pod deployment
would.  Measured per step on a flagship-class codeblock batch:

  - t_step: the full cb-sharded LDPC decode (input placement + decode +
    psum CRC accounting) over ("host", "dp");
  - t_comm: the step's cross-host collective alone (the psum CRC rollup
    on the same mesh) at the same shapes.

The communication share bounds the harness's scaling loss: projected
2-host efficiency >= 1 - t_comm / t_step.  Codeblock parallelism is the
reference's own DL/UL scaling axis (pdsch_processor_flexible_impl /
pusch_decoder codeblock pools) and is embarrassingly parallel — the
only cross-host traffic is the CRC verdict rollup.

Honesty note: virtual CPU devices SHARE the machine's physical cores,
so a wall-clock 1-vs-2-process comparison on one box measures core
contention, not scaling — this artifact instead measures the actual
DCN-crossing cost of the design.  A >=2-device deployment is needed
for end-to-end hardware efficiency; the harness (jax.distributed +
host_mesh + global_batch) is the same code path.

Usage: python benchmarks/multihost_scaling.py
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "benchmarks", "_scaling_worker.py")


def main() -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            sys.stderr.write(se[-2000:])
            raise SystemExit(f"worker failed rc={p.returncode}")
    for so, _ in outs:
        for line in so.splitlines():
            if line.startswith("RESULT "):
                print(line[len("RESULT "):])
                return
    raise SystemExit("no RESULT line")


if __name__ == "__main__":
    main()
