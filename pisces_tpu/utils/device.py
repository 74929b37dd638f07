"""Process-level device setup: the persistent compile cache and the share
of device memory each worker process may reserve."""
from __future__ import annotations

import os

# the checkout root (the directory holding the pisces_tpu package)
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a fixed path: JAX keys cache entries by it, so a moving directory never hits
DEFAULT_COMPILE_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")
# the share of device memory one JAX process reserves unless told otherwise
DEFAULT_MEM_FRACTION = 0.75
MEM_FRACTION_ENV = "XLA_PYTHON_CLIENT_MEM_FRACTION"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at JAX_COMPILATION_CACHE_DIR
    when that is set (JAX reads the variable itself), else at the fixed
    `.jax_cache` directory of this checkout. Returns the directory used."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    return DEFAULT_COMPILE_CACHE_DIR


def worker_mem_fraction(n_workers: int) -> str:
    """XLA_PYTHON_CLIENT_MEM_FRACTION for one of n_workers processes that
    share one device: 1/n of what a single process would reserve."""
    total = float(os.environ.get(MEM_FRACTION_ENV, DEFAULT_MEM_FRACTION))
    return f"{total / max(1, n_workers):.4f}"


def init_device_worker(mem_fraction: str) -> None:
    """Pool initializer: set the worker's device-memory share before the
    worker's JAX opens the device, and its compile cache."""
    os.environ[MEM_FRACTION_ENV] = mem_fraction
    configure_compile_cache()
