"""LDPC decoder kernel for NVIDIA Hopper, called through ``jax.ffi``.

The kernel (native/cuda/ldpc_decoder.cu) runs the layered normalized
min-sum schedule of the plain decoder (decoder.py) with one thread block
per codeblock: the a-posteriori LLRs stay in shared memory across all
iterations, a circulant shift is a rotated shared-memory index, the
check-to-variable messages are kept as the compressed min-sum state of each
check row, int8 LLRs go in and hard bits come out, and a syndrome early
stop ends each codeblock on its own.  Without early stop its hard bits equal
the plain decoder's.

The shared library is built from the repository's source with ``nvcc`` on
first use (``python -m srsran_project_tpu.ops.ldpc.decoder_cuda`` builds it
ahead of time) into ``native/build/``.  A CUDA kernel has no interpret
mode, so ``reference_model`` mirrors it step for step in NumPy: the CPU
tests check the kernel's algorithm against the plain decoder through it,
and the GPU tests check the kernel against the plain decoder directly.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from . import graphs
from .decoder import INPUT_CLAMP, SCALING

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SOURCE = os.path.join(_REPO, "native", "cuda", "ldpc_decoder.cu")
BUILD_DIR = os.path.join(_REPO, "native", "build")
LIBRARY = os.path.join(BUILD_DIR, "libsrsran_ldpc_cuda.so")
TARGET = "srsran_ldpc_decode"
MAX_EDGES = 320  # kMaxEdges in the kernel source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the GPU "
                           "LDPC decoder cannot be built")
    return path


def build_command(output: str) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", output, SOURCE,
    ]


def build() -> str:
    """Compile the kernel library unless an up-to-date build exists."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.SrsranLdpcDecode), platform="CUDA")


@functools.lru_cache(maxsize=None)
def kernel_plan(bg: int, z: int, n_cb: int | None):
    """Host-side graph description for the kernel: (nof_layers, ncols,
    row_start, edge_col, edge_shift) of the LBRM-truncated graph."""
    g = graphs.get_graph(bg, z)
    nl = graphs.active_layers(g, n_cb)
    rows = [g.row_edges(r) for r in range(nl)]
    row_start = np.cumsum([0] + [len(r) for r in rows]).astype(np.int32)
    edge_col = np.asarray([c for r in rows for c, _ in r], np.int32)
    edge_shift = np.asarray([s for r in rows for _, s in r], np.int32)
    assert edge_col.size <= MAX_EDGES
    return nl, g.kb + max(4, nl), row_start, edge_col, edge_shift


@functools.partial(
    jax.jit, static_argnames=("bg", "z", "nof_iterations", "early_stop", "n_cb"))
def decode(llrs: jax.Array, bg: int, z: int, nof_iterations: int = 6,
           early_stop: bool = False, n_cb: int | None = None):
    """Decode int8 circular-buffer LLRs (..., N) on the GPU.

    Returns (bits (..., K_b*Z) uint8, nof_iterations_run (...,) int32).
    The kernel reads the first (ncols-2)*Z positions of each row (the
    LBRM-truncated graph's columns; positions beyond N read 0).
    """
    if llrs.dtype != jnp.int8:
        raise TypeError(f"the GPU LDPC decoder takes int8 LLRs, got {llrs.dtype}")
    g = graphs.get_graph(bg, z)
    nl, ncols, row_start, edge_col, edge_shift = kernel_plan(bg, z, n_cb)
    _register()
    lead = llrs.shape[:-1]
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct(lead + (g.kb * z,), jnp.uint8),
         jax.ShapeDtypeStruct(lead, jnp.int32),
         jax.ShapeDtypeStruct(lead + (nl, 3, z), jnp.float32)),
        vmap_method="broadcast_all")
    bits, iters, _state = call(
        llrs, row_start=row_start, edge_col=edge_col, edge_shift=edge_shift,
        z=np.int32(z), kb=np.int32(g.kb), ncols=np.int32(ncols),
        nof_iterations=np.int32(nof_iterations),
        early_stop=np.int32(bool(early_stop)))
    return bits, iters


def reference_model(llrs, bg: int, z: int, nof_iterations: int = 6,
                    early_stop: bool = False, n_cb: int | None = None):
    """The kernel's algorithm in NumPy, step for step: compressed min-sum
    state per check row (scaled min1/min2, argmin, message signs), rotated
    column indexing, two passes per layer, per-codeblock syndrome stop.

    Returns (bits (..., K_b*Z) uint8, nof_iterations_run (...,) int32).
    """
    g = graphs.get_graph(bg, z)
    nl, ncols, row_start, edge_col, edge_shift = kernel_plan(bg, z, n_cb)
    x = np.asarray(llrs)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1]).astype(np.float32)
    c = x.shape[0]
    used = min(x.shape[1], (ncols - 2) * z)
    app = np.zeros((c, ncols * z), np.float32)
    app[:, 2 * z: 2 * z + used] = np.clip(x[:, :used], -INPUT_CLAMP, INPUT_CLAMP)
    app = app.reshape(c, ncols, z)
    s1 = np.zeros((nl, c, z), np.float32)
    s2 = np.zeros((nl, c, z), np.float32)
    amin_st = np.zeros((nl, c, z), np.int64)
    rsign_st = np.zeros((nl, c, z), np.uint32)
    scaling = np.float32(SCALING)
    iters = np.zeros(c, np.int32)
    running = np.ones(c, bool)
    t = np.arange(z)
    for _ in range(nof_iterations):
        if not running.any():
            break
        run = running[:, None]
        odd = np.zeros(c, bool)
        for l in range(nl):
            edges = list(zip(edge_col[row_start[l]:row_start[l + 1]],
                             edge_shift[row_start[l]:row_start[l + 1]]))
            deg = len(edges)
            r_old = []
            for e in range(deg):
                mag = np.where(amin_st[l] == e, s2[l], s1[l])
                r_old.append(np.where((rsign_st[l] >> e) & 1, -mag, mag))
            m1 = np.full((c, z), np.inf, np.float32)
            m2 = np.full((c, z), np.inf, np.float32)
            amin = np.zeros((c, z), np.int64)
            negmask = np.zeros((c, z), np.uint32)
            hard_par = np.zeros((c, z), bool)
            vs = []
            for e, (col, sh) in enumerate(edges):
                a = app[:, col, (t + sh) % z]
                v = (a - r_old[e]).astype(np.float32)
                vs.append(v)
                hard_par ^= a < 0
                negmask |= (v < 0).astype(np.uint32) << np.uint32(e)
                av = np.abs(v)
                lt = av < m1
                m2 = np.where(lt, m1, np.where(av < m2, av, m2))
                m1 = np.where(lt, av, m1)
                amin = np.where(lt, e, amin)
            if deg < 2:
                m2 = m1
            parity = np.zeros((c, z), np.uint32)
            for e in range(deg):
                parity ^= (negmask >> np.uint32(e)) & np.uint32(1)
            ns1 = (scaling * m1).astype(np.float32)
            ns2 = (scaling * m2).astype(np.float32)
            rsign = np.where(parity == 1, negmask ^ np.uint32((1 << deg) - 1),
                             negmask)
            for e, (col, sh) in enumerate(edges):
                nmag = np.where(amin == e, ns2, ns1)
                r_new = np.where((rsign >> np.uint32(e)) & 1, -nmag, nmag)
                pos = (t + sh) % z
                app[:, col, pos] = np.where(run, (vs[e] + r_new).astype(np.float32),
                                            app[:, col, pos])
            s1[l] = np.where(run, ns1, s1[l])
            s2[l] = np.where(run, ns2, s2[l])
            amin_st[l] = np.where(run, amin, amin_st[l])
            rsign_st[l] = np.where(run, rsign, rsign_st[l])
            odd |= hard_par.any(axis=1)
        iters += running
        if early_stop:
            running &= odd
    bits = (app.reshape(c, -1)[:, : g.kb * z] < 0).astype(np.uint8)
    return bits.reshape(lead + (g.kb * z,)), iters.reshape(lead)


if __name__ == "__main__":
    print(build())
