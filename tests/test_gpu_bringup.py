"""Bring-up on a GPU: the device kernels' parity with the f64 host backend,
device dispatch counters, compile-cache placement, chip_smoke's device
check, the native library's source stamp and the per-worker device-memory
share. Everything here runs on the CPU except the `gpu`-marked test."""
import os
import subprocess
import sys

import pytest

import conftest  # noqa: F401  (platform setup)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("max_dir_cov", [5000, 60])
def test_kernel_parity_small_cpu(max_dir_cov):
    """Both kernels agree with ops/stats.py on a seeded grid: integers and
    SB booleans exact, frequency within one ulp (chip_smoke's phase 1)."""
    from pisces_tpu.ops import parity
    report = parity.check_kernels(4096, seed=5, max_dir_cov=max_dir_cov)
    assert parity.passed(report), report


@pytest.mark.gpu
def test_kernel_parity_on_gpu():
    import jax

    from pisces_tpu.ops import parity
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform} "
                    "(run with PISCES_TESTS_ON_GPU=1 on a GPU machine)")
    report = parity.check_kernels(1 << 16, seed=1)
    assert parity.passed(report), report


def test_device_row_counters_and_byte_parity(tmp_path, monkeypatch):
    """With both dispatch thresholds at 1, every scoring batch runs on the
    device, the row counters count it, and the gVCF bytes equal the host
    run's."""
    import bench
    from pisces_tpu.apps.pisces import process_bam
    from pisces_tpu.calling import fast_gvcf
    from pisces_tpu.io.fasta import Genome
    from pisces_tpu.options import PiscesApplicationOptions
    from pisces_tpu.utils.metrics import metrics

    bam, gdir = bench.generate_wgs_workload(
        str(tmp_path / "in"), n_reads=6000, chrom_len=3000, n_var_sites=4,
        n_indel_sites=2, vf_range=(0.02, 0.08), seed=2)
    monkeypatch.setenv("PISCES_DEVICE_BATCH_THRESHOLD", "1")
    monkeypatch.setattr(fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    bodies = {}
    for use_device in (False, True):
        o = PiscesApplicationOptions()
        o.output_directory = str(tmp_path / f"dev{int(use_device)}")
        o.vcf_writing_parameters.output_gvcf_file = True
        metrics.reset()
        out = process_bam(o, bam, Genome(gdir), use_device=use_device)
        counters = metrics.snapshot()["counters"]
        with open(out) as f:
            bodies[use_device] = [l for l in f if not l.startswith("#")]
    assert counters.get("device_rows_snv_loci", 0) > 0
    assert counters.get("device_rows_reference_tuples", 0) > 0
    assert metrics.snapshot()["device"]["platform"] == "cpu"
    assert bodies[True] == bodies[False] and len(bodies[True]) > 1000


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set (and receives the cache);
    otherwise the cache goes to the fixed .jax_cache of the checkout."""
    from pisces_tpu.utils.device import DEFAULT_COMPILE_CACHE_DIR
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    cache = str(tmp_path / "cache")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = cache
    code = ("import jax\n"
            "from pisces_tpu.utils.device import configure_compile_cache\n"
            "print(configure_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    if env_set:
        code += "jax.jit(lambda x: x * 3 + 1)(2.0).block_until_ready()\n"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    want = cache if env_set else DEFAULT_COMPILE_CACHE_DIR
    assert r.stdout.split() == [want, want]
    if env_set:
        assert os.listdir(cache)


def test_chip_smoke_refuses_cpu_device():
    import jax

    import chip_smoke
    cpu = jax.devices("cpu")[0]
    with pytest.raises(SystemExit) as e:
        chip_smoke.check_device(cpu)
    assert e.value.code == 1
    chip_smoke.check_device(cpu, rehearse=True)  # rehearsal allows the CPU


def test_bench_metric_needs_gpu():
    """Without a GPU the metric stage fails and prints no METRIC line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py", "--stage", "metric"],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert "METRIC" not in r.stdout
    assert "needs a GPU" in r.stderr


def test_native_library_stamped_with_source_hash(monkeypatch):
    """The loaded library carries the hash of the sources it was built from,
    and a current stamp means build() runs no make."""
    from pisces_tpu.io import native
    assert native.get_lib() is not None
    with open(native._STAMP_PATH) as f:
        assert f.read().strip() == native.source_hash()

    def no_make(*a, **k):
        raise AssertionError("build() ran make for a current library")
    monkeypatch.setattr(native.subprocess, "run", no_make)
    assert native.build()


@pytest.mark.parametrize("n_workers,env,want", [
    (1, None, "0.7500"), (4, None, "0.1875"), (2, "0.5", "0.2500")])
def test_worker_mem_fraction(monkeypatch, n_workers, env, want):
    from pisces_tpu.utils.device import MEM_FRACTION_ENV, worker_mem_fraction
    if env is None:
        monkeypatch.delenv(MEM_FRACTION_ENV, raising=False)
    else:
        monkeypatch.setenv(MEM_FRACTION_ENV, env)
    assert worker_mem_fraction(n_workers) == want


def test_multiprocess_workers_receive_mem_fraction(monkeypatch):
    """Spawned workers started the way -MultiProcess starts them see their
    share in the environment before anything in them opens a device."""
    import multiprocessing as mp

    from pisces_tpu.utils.device import (
        MEM_FRACTION_ENV, init_device_worker, worker_mem_fraction,
    )
    monkeypatch.delenv(MEM_FRACTION_ENV, raising=False)
    ctx = mp.get_context("spawn")
    with ctx.Pool(2, initializer=init_device_worker,
                  initargs=(worker_mem_fraction(2),)) as pool:
        seen = pool.map(os.getenv, [MEM_FRACTION_ENV] * 4)
    assert seen == ["0.3750"] * 4
    assert os.environ.get(MEM_FRACTION_ENV) is None
