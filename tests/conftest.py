import os
import sys

# Run tests on a virtual 8-device CPU mesh, whatever devices the machine
# has. PISCES_TESTS_ON_GPU=1 leaves JAX its default platform instead, for
# the tests marked `gpu` (python -m pytest -m gpu tests/ on a GPU machine).
ON_GPU = os.environ.get("PISCES_TESTS_ON_GPU") == "1"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

try:
    import jax
    if not ON_GPU:
        jax.config.update("jax_platforms", "cpu")
    # no persistent compile cache: test workers run concurrently, and the
    # CLI under test points the cache into the checkout
    jax.config.update("jax_enable_compilation_cache", False)
except ImportError:
    pass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_ROOT = "/root/reference"
SHARED_BAMS = os.path.join(REFERENCE_ROOT, "src/test/SharedData/Bams")
SHARED_GENOMES = os.path.join(REFERENCE_ROOT, "src/test/SharedData/Genomes")


def shared_bam(name: str) -> str:
    return os.path.join(SHARED_BAMS, name)


def shared_genome(name: str) -> str:
    return os.path.join(SHARED_GENOMES, name)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips (inside the test) "
        "without one")
