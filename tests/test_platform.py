"""The one platform switch (support/platform.py) and the compile-cache
helper."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from srsran_project_tpu.phy.sch import SchConfig
from srsran_project_tpu.support import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,ldpc", [
    ("gpu", "cuda"), ("cpu", "xla"), ("tpu", "xla"), ("rocm", "xla"), ("unknown", "xla"),
])
def test_backend_kernel_choice(backend, ldpc):
    """Only the GPU gets a hand-written kernel; every other backend,
    including ones this repo has never seen, gets the plain XLA path."""
    assert platform.ldpc_decoder(backend) == ldpc


def test_default_backend_here_is_plain():
    assert jax.default_backend() == "cpu"
    assert platform.ldpc_decoder() == "xla"


def test_sch_decode_follows_the_switch(monkeypatch):
    """decode_transport_block asks the switch; "reference_i8" overrides it."""
    from srsran_project_tpu.ops.ldpc import decoder_cuda
    from srsran_project_tpu.phy import sch

    cfg = SchConfig(tbs=3000, target_code_rate=0.5, qm=4, nof_layers=1,
                    nof_total_bits=6000)
    llrs = jnp.full((cfg.nof_total_bits,), 10, jnp.int8)
    calls = []
    monkeypatch.setattr(platform, "ldpc_decoder", lambda backend=None: "cuda")
    monkeypatch.setattr(decoder_cuda, "decode", lambda *a, **k: calls.append(k)
                        or (jnp.zeros((1, 22 * cfg.seg.lifting_size), jnp.uint8), None))
    sch.decode_transport_block(llrs, cfg, 2, early_stop=True)
    assert calls and calls[0]["early_stop"] is True and calls[0]["n_cb"] == cfg.n_cb
    calls.clear()
    sch.decode_transport_block(llrs, dataclasses.replace(cfg, decoder="reference_i8"), 2)
    assert not calls


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from srsran_project_tpu.support import platform; "
            "d = platform.configure_compile_cache(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True).stdout.split()
    return out


def test_compile_cache_follows_env(tmp_path):
    d, cfg_dir = _cache_dir_in_child(str(tmp_path))
    assert d == str(tmp_path) and cfg_dir == str(tmp_path)


def test_compile_cache_default_in_checkout():
    d, cfg_dir = _cache_dir_in_child(None)
    assert d == cfg_dir == os.path.join(ROOT, ".jax_cache")


def test_require_gpu_refuses_cpu():
    """Measurement paths fail on the CPU instead of measuring it."""
    with pytest.raises(SystemExit, match="needs a GPU"):
        platform.require_gpu("bench")
