"""What each JAX backend runs, decided in one place, and the compile cache.

``ldpc_decoder()`` maps the default backend to the LDPC decoder it runs,
the one kernel choice there is: the GPU gets the Hopper kernel
(ops/ldpc/decoder_cuda.py); the CPU and every other backend run the plain
XLA paths.  There is no fallback: a GPU kernel that fails to build or to
compile fails the run.

``require_gpu()`` is the check every measurement path makes before it
measures: it fails without a GPU rather than measure the CPU.

``configure_compile_cache()`` points JAX's persistent compilation cache at
``$JAX_COMPILATION_CACHE_DIR`` when that is set, else at ``.jax_cache/`` in
the checkout, for every entry point (tests, apps, benchmarks, smoke run).
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def ldpc_decoder(backend: str | None = None) -> str:
    """"cuda" (decoder_cuda) on the GPU, else "xla" (decoder.decode), for
    ``backend`` (default: ``jax.default_backend()``)."""
    if backend is None:
        backend = jax.default_backend()
    return "cuda" if backend == "gpu" else "xla"


def require_gpu(tool: str, count: int = 1):
    """The devices, for a measurement path that must not fall back: exits
    with a message unless JAX's default backend is a GPU with >= count
    devices."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"{tool}: needs a GPU, JAX found {devs[0].platform}")
    if len(devs) < count:
        raise SystemExit(f"{tool}: needs {count} GPUs, found {len(devs)}")
    return devs


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def configure_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Enable the persistent compilation cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set JAX already reads it, and no
    other directory is set here."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return compile_cache_dir()
