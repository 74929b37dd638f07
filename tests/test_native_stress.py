"""Concurrency stress over the native C++ module.

Round-2 regression: pisces_io.cpp held the pileup result in a process
global (`g_pileup`), so two scheduler threads calling bam_pileup
concurrently raced delete/new (use-after-free, SIGSEGV rc=139 in the
benchmark). The result now lives on the BamFile handle; these tests pin
that a >=8-thread native-path run over a >=100k-read workload completes
and is byte-identical to the serial run (reference discipline: one job
owns one region block, RegionStateManager.cs:336-439).
"""
import hashlib
import os
import sys

import pytest

import conftest  # noqa: F401  (sets CPU platform + sys.path)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # repo-root bench module
from pisces_tpu.io.fasta import Genome
from pisces_tpu.io.native import get_lib
from pisces_tpu.options import PiscesApplicationOptions
from pisces_tpu.parallel.scheduler import process_bams_parallel


needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native module unavailable")


def _vcf_body_hash(path: str) -> str:
    body = b"".join(line.encode() for line in open(path)
                    if not line.startswith("##"))
    return hashlib.sha256(body).hexdigest()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("stress_wl"))
    bam, gdir = bench._write_synthetic_workload(
        tmp, n_chroms=4, chrom_len=300_000, n_reads=120_000,
        variant_rate=0.01)
    return bam, Genome(gdir)


def _run(workload, out_dir: str, threads: int) -> str:
    bam, genome = workload
    o = PiscesApplicationOptions()
    o.output_directory = out_dir
    os.makedirs(out_dir, exist_ok=True)
    o.vcf_writing_parameters.output_gvcf_file = True
    outs = process_bams_parallel(o, [bam], genome, threads,
                                 use_device=False)
    return outs[0]


@needs_native
def test_eight_threads_byte_identical_to_serial(workload, tmp_path):
    serial = _run(workload, str(tmp_path / "t1"), threads=1)
    threaded = _run(workload, str(tmp_path / "t8"), threads=8)
    assert _vcf_body_hash(serial) == _vcf_body_hash(threaded)


@needs_native
def test_concurrent_native_pileup_distinct_handles(workload):
    """Hammer native_pileup from 8 threads over per-thread handles: this is
    the exact interleaving that crashed round 2's bench (rc=139)."""
    import threading

    import numpy as np

    from pisces_tpu.domain.types import BASE_TO_ALLELE
    from pisces_tpu.io.native import NativeBamReader, native_pileup

    bam, genome = workload
    chrom = genome.get_chr_reference(genome.chromosome_names[0])
    ref_codes = BASE_TO_ALLELE[chrom.sequence]
    errors = []

    def worker(seed):
        try:
            r = NativeBamReader(bam)
            batch = r.fetch(ref_id=0)
            keep = np.ones(batch.n, dtype=bool)
            for _ in range(3):
                pc, mm = native_pileup(r, keep, 20, 5, 1000,
                                       ref_codes=ref_codes)
                assert pc.counts_t.sum() > 0
                assert mm is not None
            r.close()
        except Exception as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


@needs_native
def test_bench_wes_path_executes():
    """bench.py's WES function itself must run (threads=4): the round-2
    BENCH failure mode was this exact call dying with rc=139."""
    reads_s, loci_s, wall = bench.bench_end_to_end_wes(
        tmp="/tmp/pisces_tpu_test_wes", threads=4)
    assert reads_s > 0 and loci_s > 0 and wall > 0
