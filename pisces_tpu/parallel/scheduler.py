"""Job scheduling: (bam x chromosome) data parallelism with ordered output.

Maps the reference's parallelism mechanisms (SURVEY §2.5) onto host
executors:
  P1  thread-per-(bam,chr) jobs with a bounded pool (JobManager.cs:27-149,
      BaseGenomeProcessor.cs:40-135) -> ThreadPoolExecutor
  P2  per-bam ordered throttling (AutoResetEvent chains) -> completion
      buffer drained in genome order per bam
  P3  per-chr output sharding + concatenation (GenomeProcessor.cs:81-186)
      -> per-chr temp VCFs merged after the header
  P4/P5 multi-process per-chromosome -> multiprocessing pool

Chromosome references are loaded once and shared across bams (the chr
reference caching/refcounting of BaseGenomeProcessor.cs:137-183).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu.utils.logger import log


class JobManager:
    """Bounded-thread job runner with the reference's error modes
    (None / Wait / Terminate)."""

    def __init__(self, max_threads: int, error_mode: str = "terminate"):
        self.max_threads = max(1, max_threads)
        self.error_mode = error_mode

    def process(self, jobs: List[Callable[[], None]]) -> None:
        if not jobs:
            return
        errors: List[BaseException] = []
        with cf.ThreadPoolExecutor(max_workers=self.max_threads) as pool:
            futures = [pool.submit(j) for j in jobs]
            for f in cf.as_completed(futures):
                exc = f.exception()
                if exc is not None:
                    errors.append(exc)
                    if self.error_mode == "terminate":
                        for other in futures:
                            other.cancel()
                        break
        if errors and self.error_mode in ("terminate", "wait"):
            raise errors[0]


class ChrReferenceCache:
    """Load each chromosome once; drop it when all bams are done with it."""

    def __init__(self, genome, n_consumers: int):
        self._genome = genome
        self._n_consumers = n_consumers
        self._lock = threading.Lock()
        self._cache: Dict[str, object] = {}
        self._remaining: Dict[str, int] = {}

    def get(self, name: str):
        with self._lock:
            if name not in self._cache:
                self._cache[name] = self._genome.get_chr_reference(name)
                self._remaining[name] = self._n_consumers
            return self._cache[name]

    def release(self, name: str) -> None:
        with self._lock:
            if name in self._remaining:
                self._remaining[name] -= 1
                if self._remaining[name] <= 0:
                    self._cache.pop(name, None)
                    self._remaining.pop(name, None)
                    # also drop it from the Genome-level LRU, or the
                    # release frees nothing (whole-genome sweeps would
                    # pin the 4 most recent chromosomes, ~1 GB)
                    evict = getattr(self._genome, "evict_chr_reference",
                                    None)
                    if evict is not None:
                        evict(name)


@dataclass
class _ChrResult:
    chrom_name: str
    alleles: Optional[list] = None
    done: bool = False


class OrderedChromosomeWriter:
    """P2: workers complete chromosomes in any order; the writer emits them
    in genome order for one output vcf."""

    def __init__(self, chrom_names: List[str]):
        self._order = chrom_names
        self._results: Dict[str, _ChrResult] = {
            c: _ChrResult(c) for c in chrom_names}
        self._cond = threading.Condition()
        self._next_index = 0

    def submit(self, chrom_name: str, alleles: list) -> None:
        with self._cond:
            r = self._results[chrom_name]
            r.alleles = alleles
            r.done = True
            self._cond.notify_all()

    def drain(self, write_fn: Callable[[str, list], None]) -> None:
        """Blocks until every chromosome is emitted, in order."""
        for name in self._order:
            with self._cond:
                while not self._results[name].done:
                    self._cond.wait()
                alleles = self._results[name].alleles
            write_fn(name, alleles)
            # free memory as we go
            self._results[name].alleles = None


def process_bams_parallel(options, bam_paths: List[str], genome,
                          max_threads: int = 8,
                          use_device: bool = True,
                          thread_by_chr: bool = False) -> List[str]:
    """GenomeProcessor.Execute equivalent: all (bam, chr) jobs through one
    bounded pool, per-bam in-order VCF emission."""
    from pisces_tpu.apps.pisces import (
        _load_intervals, call_chromosome, load_forced_alleles,
    )
    from pisces_tpu.io.native import open_bam
    from pisces_tpu.io.vcf_write import VcfWriter, VcfWriterConfig
    from pisces_tpu.calling.intervals import make_region_mapper

    options.validate()
    chrom_names = genome.chromosome_names
    cache = ChrReferenceCache(genome, len(bam_paths))
    forced = (load_forced_alleles(options.forced_alleles_paths)
              if options.forced_alleles_paths else None)

    outputs = []
    writers: Dict[str, Tuple[VcfWriter, OrderedChromosomeWriter]] = {}
    gvcf = options.vcf_writing_parameters.output_gvcf_file
    for bam_path in bam_paths:
        stem = os.path.basename(bam_path)
        stem = stem[:-4] if stem.endswith(".bam") else stem
        out_dir = options.output_directory or os.path.dirname(bam_path)
        os.makedirs(out_dir, exist_ok=True)
        out_vcf = os.path.join(out_dir,
                               stem + (".genome.vcf" if gvcf else ".vcf"))
        outputs.append(out_vcf)
        wcfg = VcfWriterConfig(options, has_forced_gt=bool(forced))
        # sample column = bam file name incl. extension (reference
        # VcfFileWriter; cf. shipped expected outputs "PhiX_S3.bam")
        writer = VcfWriter(out_vcf, wcfg, genome.directory,
                           os.path.basename(bam_path),
                           genome.chromosome_lengths, options.command_line)
        writer.write_header()
        writers[bam_path] = (writer, OrderedChromosomeWriter(chrom_names))

    # The native handle's decoded-batch state is consumed by the downstream
    # pileup call, so a handle cannot be shared across concurrently-running
    # jobs. A per-bam pool bounds the number of full-file inflations to the
    # number of concurrent jobs instead of one per (bam, chr).
    pools: Dict[str, List] = {p: [] for p in bam_paths}
    pool_lock = threading.Lock()

    def _borrow(bam_path: str):
        with pool_lock:
            if pools[bam_path]:
                return pools[bam_path].pop()
        return open_bam(bam_path)

    def _give_back(bam_path: str, reader) -> None:
        with pool_lock:
            pools[bam_path].append(reader)

    def _emit(writer: "VcfWriter", chrom_name: str, payload) -> None:
        """Write one chromosome's results through a (possibly headerless)
        writer: spliced fast-gVCF streams or object-path alleles + mapper."""
        if not payload:
            return
        alleles, intervals = payload
        if isinstance(alleles, tuple):
            from pisces_tpu.apps.pisces import write_spliced
            write_spliced(writer, alleles[0], alleles[1])
            return
        chrom = genome.get_chr_reference(chrom_name)
        mapper = make_region_mapper(options, chrom, intervals)
        writer.write(alleles, mapper)
        writer.write_remaining(mapper)

    def _compute(bam_path: str, chrom_name: str, bam):
        """The per-(bam, chr) calling work; returns the emit payload."""
        if chrom_name not in bam.header.ref_names:
            return []
        chrom = cache.get(chrom_name)
        try:
            intervals = _load_intervals(options, chrom_name)
            alleles = call_chromosome(options, chrom, bam, intervals,
                                      use_device, forced)
            if isinstance(alleles, tuple):
                # emission is DEFERRED (ordered per-bam writer) while the
                # reader handle returns to the pool for the next job — the
                # fast-gVCF positions array is a zero-copy view into that
                # handle's buffers and must be detached here
                out_alleles, ref_lines = alleles
                if ref_lines is not None:
                    positions, lines = ref_lines
                    ref_lines = (np.array(positions), lines)
                alleles = (out_alleles, ref_lines)
            return (alleles, intervals)
        finally:
            cache.release(chrom_name)

    if thread_by_chr:
        # GenomeProcessor.cs:81-186 "one writer per bam and per chr": each
        # job writes a headerless per-chromosome shard the moment it
        # finishes (no ordering wait, no in-memory holding of out-of-order
        # results); after the pool drains, shards are byte-concatenated
        # onto the header file in genome order (CombinePerChromosomeFiles).
        shard_paths: Dict[Tuple[str, str], str] = {}
        shard_lock = threading.Lock()

        def job(bam_path: str, chrom_name: str) -> None:
            bam = _borrow(bam_path)
            try:
                payload = _compute(bam_path, chrom_name, bam)
                if not payload:
                    return
                writer, _ = writers[bam_path]
                base = outputs[bam_paths.index(bam_path)]
                shard = f"{base}_{chrom_name}"
                shard_writer = VcfWriter(
                    shard, writer.config, genome.directory,
                    os.path.basename(bam_path), genome.chromosome_lengths,
                    options.command_line)
                try:
                    _emit(shard_writer, chrom_name, payload)
                finally:
                    shard_writer.close()
                with shard_lock:
                    shard_paths[(bam_path, chrom_name)] = shard
            finally:
                _give_back(bam_path, bam)

        jobs = [(__import__("functools").partial(job, b, c))
                for c in chrom_names for b in bam_paths]
        JobManager(max_threads).process(jobs)
        for bam_path, out_vcf in zip(bam_paths, outputs):
            writer, _ = writers[bam_path]
            writer.close()  # header-only so far
            with open(out_vcf, "ab") as out_f:
                for chrom_name in chrom_names:
                    shard = shard_paths.get((bam_path, chrom_name))
                    if shard is None:
                        continue
                    with open(shard, "rb") as s:
                        out_f.write(s.read())
                    os.remove(shard)
        return outputs

    def job(bam_path: str, chrom_name: str) -> None:
        _, ordered = writers[bam_path]
        bam = _borrow(bam_path)
        try:
            try:
                payload = _compute(bam_path, chrom_name, bam)
            except Exception:
                ordered.submit(chrom_name, [])
                raise
            ordered.submit(chrom_name, payload)
        finally:
            _give_back(bam_path, bam)

    jobs = [(__import__("functools").partial(job, b, c))
            for c in chrom_names for b in bam_paths]

    drainers = []
    for bam_path in bam_paths:
        writer, ordered = writers[bam_path]

        def drain(bam_path=bam_path, writer=writer, ordered=ordered):
            def write_fn(chrom_name, payload):
                _emit(writer, chrom_name, payload)
            ordered.drain(write_fn)
            writer.close()
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        drainers.append(t)

    JobManager(max_threads).process(jobs)
    for t in drainers:
        t.join()
    return outputs


def process_chromosomes_multiprocess(options, bam_path: str, genome_dir: str,
                                     n_processes: int = 4,
                                     use_device: bool = False,
                                     resume: bool = False) -> str:
    """P4/P5: one worker process per chromosome, per-chr vcf shards merged
    by byte concatenation after the header (MultiProcess + ThreadByChr).

    Shards are written atomically (tmp + rename), so a shard file on disk is
    a completed unit of work. With resume=True a killed run restarts at
    shard granularity: completed chromosomes are not re-called (the
    checkpoint/resume design SURVEY.md flags as this rebuild's upgrade of
    the reference's crash-retains-completed-chr-files behavior,
    GenomeProcessor.cs:156-186). With use_device, each worker reserves
    1/n_workers of the device memory one process would take."""
    import json
    import multiprocessing as mp

    from pisces_tpu.io.fasta import Genome
    from pisces_tpu.utils import logger

    genome = Genome(genome_dir)
    out_dir = options.output_directory or os.path.dirname(bam_path)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.basename(bam_path)
    stem = stem[:-4] if stem.endswith(".bam") else stem
    gvcf = options.vcf_writing_parameters.output_gvcf_file
    final_vcf = os.path.join(out_dir, stem + (".genome.vcf" if gvcf else ".vcf"))
    manifest_path = os.path.join(out_dir, f"{stem}.progress.json")

    chrom_names = genome.chromosome_names
    shard_of = {c: os.path.join(out_dir, f"{stem}.vcf_{c}")
                for c in chrom_names}
    done = {c for c in chrom_names
            if resume and os.path.exists(shard_of[c])}
    if done:
        logger.log(f"resume: skipping {len(done)} completed shard(s): "
                   + ",".join(sorted(done)))
    todo = [c for c in chrom_names if c not in done]
    args = [(options, bam_path, genome_dir, c, use_device, shard_of[c])
            for c in todo]

    def write_manifest():
        with open(manifest_path + ".tmp", "w") as f:
            json.dump({"bam": bam_path, "completed": sorted(done),
                       "total": len(chrom_names)}, f, indent=1)
        os.replace(manifest_path + ".tmp", manifest_path)

    write_manifest()
    if args:
        ctx = mp.get_context("spawn")
        n_workers = min(n_processes, len(args))
        # each worker process is its own JAX client of the one device:
        # without a share, the first reserves most of its memory and the
        # second fails to allocate
        init, init_args = None, ()
        if use_device:
            from pisces_tpu.utils.device import (
                init_device_worker, worker_mem_fraction,
            )
            init, init_args = (init_device_worker,
                               (worker_mem_fraction(n_workers),))
        with ctx.Pool(n_workers, initializer=init,
                      initargs=init_args) as pool:
            for chrom, _path in pool.imap_unordered(_run_chromosome_shard,
                                                    args):
                done.add(chrom)
                write_manifest()

    # merge: full header from shard 0, then data lines of each shard in order
    with open(final_vcf, "w", newline="\n") as out:
        wrote_header = False
        for c in chrom_names:
            sp = shard_of[c]
            if not os.path.exists(sp):
                continue
            with open(sp) as f:
                for line in f:
                    if line.startswith("#"):
                        if not wrote_header:
                            out.write(line)
                    else:
                        out.write(line)
            wrote_header = True
            os.unlink(sp)
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)
    return final_vcf


def _run_chromosome_shard(args):
    options, bam_path, genome_dir, chrom_name, use_device, out_path = args
    from pisces_tpu.apps.pisces import process_bam
    from pisces_tpu.io.fasta import Genome
    options.chromosome_filter = chrom_name
    genome = Genome(genome_dir)
    tmp_path = out_path + ".tmp"
    process_bam(options, bam_path, genome, out_vcf=tmp_path,
                use_device=use_device)
    os.replace(tmp_path, out_path)
    return chrom_name, out_path
