"""Stage synchronization control for the first (compiling) call.

One synchronous warmup pass blocks after every jitted stage, so compiles
happen one at a time and each stage's first call can be timed on its own
(SRSRAN_STAGE_DEBUG=1 prints them); steady state then dispatches fully
asynchronously.

Usage:
    with staging.sync_stages():
        run_slot(...)          # warmup: compiles happen one-by-one
    run_slot(...)              # steady state: async pipelining
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import jax

_SYNC = False
_DEBUG = os.environ.get("SRSRAN_STAGE_DEBUG") == "1"
_COUNT = 0


def sync_enabled() -> bool:
    return _SYNC


def checkpoint(x):
    """Block on x if synchronous staging is active; returns x.

    No-op under tracing (jit/vmap) so stage functions can be fused into
    larger compiled programs without the sync hook failing on tracers."""
    global _COUNT
    if _SYNC and not any(
        isinstance(l, jax.core.Tracer) for l in jax.tree_util.tree_leaves(x)
    ):
        t0 = time.monotonic()
        jax.block_until_ready(x)
        if _DEBUG:
            _COUNT += 1
            print(f"# stage {_COUNT}: {time.monotonic()-t0:.1f}s", file=sys.stderr, flush=True)
    return x


@contextlib.contextmanager
def sync_stages():
    global _SYNC
    prev = _SYNC
    _SYNC = True
    try:
        yield
    finally:
        _SYNC = prev
