"""Pisces-equivalent somatic small-variant caller application.

Orchestration port of exe/Pisces (Program.cs:11-53, Logic/Factory.cs:30-399,
Logic/SmallVariantCaller.cs:79-116, Logic/Processing/GenomeProcessor.cs:13-193):
per (BAM x chromosome) work, candidate finding + pileup counts + per-locus
scoring, VCF/gVCF output.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from pisces_tpu.options import PiscesApplicationOptions
from pisces_tpu.domain.types import AlleleCategory
from pisces_tpu.io.bam import BamReader, filter_batch
from pisces_tpu.io.fasta import ChrReference, Genome
from pisces_tpu.io.vcf_write import VcfWriter, VcfWriterConfig
from pisces_tpu.calling.caller import (
    AlleleCaller, CallerConfig, make_reference_candidates,
)
from pisces_tpu.calling.collapser import VariantCollapser
from pisces_tpu.calling.source import AlleleSource
from pisces_tpu.pileup.candidates import find_candidates_batch
from pisces_tpu.pileup.counts import build_counts_device, build_counts_host
from pisces_tpu.pileup.events import build_base_events
from pisces_tpu.utils.logger import log
from pisces_tpu.utils.metrics import metrics


def _fast_gvcf_eligible(options: PiscesApplicationOptions,
                        forced_alleles) -> bool:
    """Whether the columnar fast-gVCF reference path applies.

    The fused device kernel implements SOMATIC ref-line GT/GQ; diploid
    thresholding routes through a vectorized f64 host twin
    (fast_gvcf._score_host_tuples_diploid); haploid and adaptive ploidy go
    through the object path. MNV mode and collapsed-count reporting need
    per-candidate objects; crushed loci with forced alleles need the
    colocated writer to merge ref+forced lines; a LowGQ filter threshold
    needs the per-allele filter pass."""
    from pisces_tpu.domain.types import PloidyModel as _PM
    v = options.variant_calling_parameters
    return (options.vcf_writing_parameters.output_gvcf_file
            and options.use_fast_gvcf
            and not options.call_mnvs
            and not options.vcf_writing_parameters.report_rc_counts
            and v.ploidy_model in (_PM.SOMATIC, _PM.DIPLOID_BY_THRESHOLDING)
            and v.low_genotype_quality_filter is None
            and (options.vcf_writing_parameters
                 .allow_multiple_vcf_lines_per_loci
                 or not forced_alleles))


def call_chromosome(options: PiscesApplicationOptions, chrom: ChrReference,
                    bam: BamReader, intervals=None, use_device: bool = True,
                    forced_alleles=None, priors=None):
    """Run the full calling pipeline for one chromosome; returns the list of
    called alleles in genome order (the per-chromosome unit of P1 parallelism)."""
    cfg = CallerConfig.from_options(options)
    cfg.use_device_candidates = use_device
    bf = options.bam_filter_parameters
    track_amplicons = (
        options.variant_calling_parameters.amplicon_bias_filter_threshold
        is not None)
    source_is_stitched = (bam.header.source_is_stitched
                          or options.use_stitched_xd_info)
    source_is_collapsed = bam.header.source_is_collapsed
    need_tags = (track_amplicons or source_is_stitched or source_is_collapsed
                 or options.vcf_writing_parameters.report_rc_counts)

    ref_id = bam.header.ref_index(chrom.name)
    with metrics.stage("bam_fetch"):
        # both readers decode tags natively (C++ TagUtils analog in
        # pisces_io.cpp bam_decode_tags; Python _parse_string_tags).
        # The native reader serves seq/qual/cigar as zero-copy views:
        # this pipeline consumes the batch before the handle's next
        # decode, and pileup does not invalidate decode columns.
        # Capability-checked explicitly (not try/except TypeError, which
        # would mask genuine TypeErrors from inside the fetch).
        if getattr(bam, "supports_view_fetch", False):
            batch = bam.fetch(ref_id=ref_id, parse_tags=need_tags,
                              as_views=True)
        else:
            batch = bam.fetch(ref_id=ref_id, parse_tags=need_tags)
    metrics.count("reads", batch.n)
    keep = filter_batch(batch, bf.minimum_map_quality, bf.remove_duplicates,
                        bf.only_use_proper_pairs)

    base_dirs = None
    if source_is_stitched and batch.xd_tags is not None:
        from pisces_tpu.pileup.directions import batch_base_directions
        base_dirs = batch_base_directions(batch, keep)

    from pisces_tpu.pileup.counts import candidate_anchor_positions
    from pisces_tpu.io.native import NativeBamReader, native_pileup
    mesh_mode = options.mesh_devices > 1
    mesh_events = None
    # the native handle may sit behind a _RegionView (windowed streaming)
    native_reader = bam if isinstance(bam, NativeBamReader) \
        else getattr(bam, "_reader", None)
    if not isinstance(native_reader, NativeBamReader):
        native_reader = None
    native_flow = (native_reader is not None
                   and getattr(batch, "_from_native_handle", False)
                   and not options.call_mnvs and not track_amplicons
                   and batch.extra_tags is None
                   and not mesh_mode)  # mesh scoring shards the event stream
    if native_flow:
        # C++ hot loop: events + scatter + SNV mismatch extraction in one pass
        from pisces_tpu.domain.types import BASE_TO_ALLELE
        from pisces_tpu.pileup.candidates_fast import (
            aggregate_native_mismatches, find_indel_candidates,
        )
        with metrics.stage("candidates"):
            indels = find_indel_candidates(
                chrom.name, chrom.sequence, batch, keep,
                bf.minimum_base_call_quality, options.tracked_anchor_size,
                track_open_ended=options.collapse, base_dirs=base_dirs)
        anchor_positions = candidate_anchor_positions(indels)
        if base_dirs is not None:
            base_dirs = np.ascontiguousarray(base_dirs, dtype=np.int8)
        with metrics.stage("pileup"):
            pc, mm = native_pileup(native_reader, keep,
                                   bf.minimum_base_call_quality,
                                   options.tracked_anchor_size, 1000,
                                   anchor_positions, base_dirs,
                                   ref_codes=BASE_TO_ALLELE[chrom.sequence],
                                   track_open_ended=options.collapse)
        with metrics.stage("candidates"):
            candidates = aggregate_native_mismatches(
                chrom.name, chrom.sequence, *mm) + indels
    else:
        candidates, _ = find_candidates_batch(
            chrom.name, chrom.sequence, batch, keep,
            bf.minimum_base_call_quality, options.call_mnvs,
            options.max_size_mnv, options.max_gap_between_mnv,
            options.tracked_anchor_size,
            track_open_ended=options.collapse,
            track_amplicons=track_amplicons)
        anchor_positions = candidate_anchor_positions(candidates)
        if native_reader is not None and getattr(
                batch, "_from_native_handle", False) and not mesh_mode:
            if base_dirs is not None:
                base_dirs = np.ascontiguousarray(base_dirs, dtype=np.int8)
            pc, _mm = native_pileup(native_reader, keep,
                                    bf.minimum_base_call_quality,
                                    options.tracked_anchor_size,
                                    1000, anchor_positions, base_dirs)
        else:
            ev = build_base_events(batch, keep, bf.minimum_base_call_quality,
                                   options.tracked_anchor_size,
                                   base_dirs=base_dirs)
            mesh_events = ev if mesh_mode else None
            builder = build_counts_device if use_device else build_counts_host
            pc = builder(ev, anchor_size=options.tracked_anchor_size,
                         anchored_positions=anchor_positions)

    amp_cov = None
    if track_amplicons:
        from pisces_tpu.pileup.amplicons import amplicon_coverage
        amp_cov = amplicon_coverage(batch, keep, bf.minimum_base_call_quality)
    source = AlleleSource(pc, expect_stitched_reads=source_is_stitched,
                          amplicon_coverage=amp_cov)

    read_summaries = None
    from pisces_tpu.domain.types import CoverageMethod
    if options.coverage_method == CoverageMethod.EXACT:
        from pisces_tpu.ops.exact_coverage import build_read_summaries
        read_summaries = build_read_summaries(batch, keep, base_dirs)

    if forced_alleles:
        from pisces_tpu.pileup.candidates import Candidate
        from pisces_tpu.io.vcf_read import classify
        existing = {(c.position, c.ref_allele, c.alt_allele) for c in candidates}
        for (chrom_name, pos, ref, alt) in sorted(forced_alleles):
            if chrom_name != chrom.name:
                continue
            if (pos, ref, alt) in existing:
                continue
            fc = Candidate(chrom.name, pos, ref, alt, classify(ref, alt))
            fc.is_forced = True
            candidates.append(fc)

    # effective ploidy is per chromosome (chrM always somatic; sex
    # chromosomes go haploid with -gender — GenotypeCreator
    # .GetPloidyForThisChr); only somatic/diploid ref rules are columnar
    from pisces_tpu.domain.types import PloidyModel as _PM
    from pisces_tpu.genotype import get_ploidy_for_chr
    _v = options.variant_calling_parameters
    eff_ploidy = get_ploidy_for_chr(_v.ploidy_model, _v.is_male, chrom.name)
    fast_gvcf = (_fast_gvcf_eligible(options, forced_alleles)
                 and eff_ploidy in (_PM.SOMATIC,
                                    _PM.DIPLOID_BY_THRESHOLDING))
    if options.vcf_writing_parameters.output_gvcf_file and not fast_gvcf:
        candidates = candidates + make_reference_candidates(
            chrom.name, chrom.sequence, pc, intervals)

    collapser = None
    if options.collapse:
        known = priors.get(chrom.name) if priors else None
        collapser = VariantCollapser(
            known, options.exclude_mnvs_from_collapsing,
            cfg.consider_anchor_information,
            options.collapse_freq_threshold, options.collapse_freq_ratio_threshold)

    caller = AlleleCaller(cfg, chrom.sequence, collapser, intervals,
                          read_summaries=read_summaries)
    if forced_alleles:
        caller.forced_alleles = {f for f in forced_alleles if f[0] == chrom.name}
    with metrics.stage("allele_calling"):
        by_position = caller.call(candidates, source, max_position=None)
    metrics.count("candidates_scored", len(candidates))

    if options.vcf_writing_parameters.report_rc_counts and \
            batch.extra_tags is not None:
        from pisces_tpu.pileup.collapsed import (
            assign_collapsed_totals, collapsed_total_counts,
        )
        totals = collapsed_total_counts(batch, keep,
                                        bf.minimum_base_call_quality, base_dirs)
        assign_collapsed_totals(by_position, totals)

    ref_lines = None
    if fast_gvcf:
        from pisces_tpu.calling.fast_gvcf import (
            format_reference_lines, score_reference_positions,
        )
        from pisces_tpu.ops.scoring_params import ScoringParams
        v = options.variant_calling_parameters
        params = ScoringParams(
            noise_level=v.noise_level_used_for_q_scoring,
            max_variant_qscore=v.maximum_variant_qscore,
            min_variant_qscore=v.minimum_variant_qscore,
            variant_qscore_filter=v.minimum_variant_qscore_filter,
            min_frequency=v.minimum_frequency,
            min_frequency_filter=max(v.minimum_frequency_filter,
                                     v.minimum_frequency),
            target_lod=cfg.target_lod_frequency,
            min_depth=v.minimum_coverage,
            low_depth_filter=v.low_depth_filter or v.minimum_coverage,
            min_gq=v.minimum_genotype_qscore,
            max_gq=v.maximum_genotype_qscore,
            sb_acceptance=v.strand_bias_acceptance_criteria,
            no_call_filter=v.no_call_filter_threshold)
        diploid_params = (v.diploid_snv_thresholding_parameters
                          if eff_ploidy == _PM.DIPLOID_BY_THRESHOLDING
                          else None)
        with metrics.stage("gvcf_scoring"):
            if (mesh_mode and mesh_events is not None
                    and diploid_params is None):
                from pisces_tpu.parallel.sharding import (
                    get_mesh, sharded_score_reference_positions,
                )
                positions, scored, shard_stats = \
                    sharded_score_reference_positions(
                        mesh_events, chrom.sequence, params,
                        get_mesh(options.mesh_devices), intervals)
                for _sk, _sv in shard_stats.items():
                    metrics.count(_sk, _sv)
            else:
                positions, scored = score_reference_positions(
                    pc, chrom.sequence, params, use_device=use_device,
                    intervals=intervals, diploid_snv_params=diploid_params)
        metrics.count("loci_scored", len(positions))
        if use_device:
            metrics.device_watermark()
        if scored is not None:
            # loci whose ref allele was suppressed by a coexisting variant
            # that genotyping later pruned entirely (diploid sub-threshold
            # case) emit NOTHING — mirror the object path's locus pruning
            suppressed = caller.ref_suppressed_positions - {
                p for p, lst in by_position.items() if lst}
            if suppressed:
                m = ~np.isin(positions, np.fromiter(suppressed, np.int64))
                positions = positions[m]
                scored["inv"] = scored["inv"][m]
                scored["ref_base"] = scored["ref_base"][m]
            wcfg = VcfWriterConfig(options)
            with metrics.stage("gvcf_formatting"):
                ref_lines = (positions, format_reference_lines(
                    chrom.name, positions, scored, wcfg,
                    v.low_depth_filter or v.minimum_coverage,
                    v.minimum_variant_qscore_filter))

    out: List = []
    for pos in sorted(by_position):
        out.extend(by_position[pos])
    log(f"{chrom.name}: {caller.total_num_called} alleles called. "
        f"{caller.total_num_collapsed} variants collapsed.")
    if fast_gvcf:
        return out, ref_lines
    return out


def write_spliced(writer, variant_alleles, ref_lines) -> None:
    """Merge the columnar reference-line stream with object-path variant
    alleles, in position order; ref lines at emitted-variant positions are
    pruned (ComputeGenotypeAndFilterAllele ref-pruning semantics) UNLESS
    every variant there is forced-to-report — the reference keeps the
    locus's reference allele when only forced alleles coexist
    (AlleleCaller.cs:143-150 guards the prune on a non-forced variant)."""
    from pisces_tpu.calling.fast_gvcf import RefLineBlock

    variant_positions = {}
    for a in variant_alleles:
        variant_positions.setdefault(a.position, []).append(a)
    if ref_lines is None:
        positions = np.empty(0, np.int64)
        lines = []
    else:
        positions, lines = ref_lines
        positions = np.asarray(positions, dtype=np.int64)
    fh = writer._fh
    ri = 0
    n_ref = len(positions)
    is_block = isinstance(lines, RefLineBlock)

    def _line(i: int) -> str:
        return lines.line(i) if is_block else lines[i]

    def _bulk_refs_upto(j: int) -> None:
        nonlocal ri
        if is_block:
            # single buffer-slice write: no per-line string objects. The
            # pre-write text flush is genuinely required here: every ref
            # run in this interleaving is preceded by variant text (each
            # locus writes at least one variant line), so there is no
            # elidable flush to skip.
            if j > ri:
                lines.write_range(fh, ri, j)
            ri = max(ri, j)
            return
        while j > ri:
            # chunked join: bounded peak memory on WGS-length runs
            k = min(j, ri + 262_144)
            fh.write("\n".join(lines[ri:k]))
            fh.write("\n")
            ri = k

    for pos in sorted(variant_positions):
        # bulk-write the run of reference lines before this variant locus
        _bulk_refs_upto(int(np.searchsorted(positions, pos)))
        has_ref_line = ri < n_ref and int(positions[ri]) == pos
        at_pos = variant_positions[pos]
        all_forced = all(getattr(a, "is_forced_to_report", False)
                         for a in at_pos)
        keep_ref = has_ref_line and all_forced
        if writer.config.allow_multiple_vcf_lines_per_loci:
            # locus ordering is by (ref, alt) with the reference line
            # keyed by its base (AlleleCaller.cs:172-176 sort)
            ref_key = None
            if keep_ref:
                ref_base = _line(ri).split("\t", 4)[3]
                ref_key = (ref_base, ref_base)
            wrote_ref = False
            for a in at_pos:
                if (ref_key is not None and not wrote_ref
                        and ref_key <= (a.ref_allele, a.alt_allele)):
                    fh.write(_line(ri) + "\n")
                    wrote_ref = True
                writer.write_colocated([a])
            if ref_key is not None and not wrote_ref:
                fh.write(_line(ri) + "\n")
        else:
            if keep_ref:
                fh.write(_line(ri) + "\n")
            writer.write_colocated(at_pos)
        if has_ref_line:
            ri += 1
    _bulk_refs_upto(n_ref)


def load_forced_alleles(paths: List[str]) -> set:
    """Factory.GetForcedAlleles: load (chrom, pos, ref, alt) tuples from VCFs,
    rejecting invalid alts."""
    from pisces_tpu.io.vcf_read import read_header_and_variants
    out = set()
    for path in paths:
        _, variants = read_header_and_variants(path)
        for v in variants:
            for alt in v.alt_allele.split(","):
                ref = v.ref_allele.upper()
                a = alt.upper()
                if a == ref or any(ch not in "ACGT" for ch in a):
                    log(f"Invalid forced genotyping variant: {v.chrom}:"
                        f"{v.position} {ref}>{a}")
                    continue
                out.add((v.chrom, v.position, ref, a))
    return out


class _RegionView:
    """Reader shim exposing one genomic window of a lazy indexed BAM as if
    it were the whole file, so call_chromosome can run per window with
    bounded memory (the streaming analog of the reference's 1000-bp block
    recycling, RegionStateManager.cs:425-439, scaled to .bai granularity)."""

    def __init__(self, reader, ref_id: int, beg0: int, end0: int):
        self._reader = reader
        self._ref_id = ref_id
        self._beg0 = beg0
        self._end0 = end0
        self.header = reader.header
        self.path = reader.path

    @property
    def supports_view_fetch(self) -> bool:
        return getattr(self._reader, "supports_view_fetch", False)

    def fetch(self, ref_id=None, parse_tags: bool = False,
              as_views: bool = False):
        if as_views and self.supports_view_fetch:
            return self._reader.fetch_region(
                self._ref_id, self._beg0, self._end0,
                parse_tags=parse_tags, as_views=True)
        return self._reader.fetch_region(self._ref_id, self._beg0, self._end0,
                                         parse_tags=parse_tags)


def _trim_window_result(result, w0: int, w1: int, copy_positions: bool):
    """Keep only loci inside [w0+1, w1] (1-based). copy_positions=True
    detaches the positions array from the producing reader handle's native
    buffers (required when the same worker will run another window before
    this result is consumed — pipelined mode)."""
    if isinstance(result, tuple):
        alleles, ref_lines = result
        alleles = [a for a in alleles if w0 < a.position <= w1]
        if ref_lines is not None:
            from pisces_tpu.calling.fast_gvcf import RefLineBlock
            positions, lines = ref_lines
            # window-interior positions form a contiguous run
            lo = int(np.searchsorted(positions, w0 + 1))
            hi = int(np.searchsorted(positions, w1, side="right"))
            kept = (lines.slice(lo, hi)
                    if isinstance(lines, RefLineBlock)
                    else lines[lo:hi])
            pos_kept = positions[lo:hi]
            if copy_positions:
                pos_kept = np.array(pos_kept)
            ref_lines = (pos_kept, kept)
        return alleles, ref_lines
    return [a for a in result if w0 < a.position <= w1], None


def call_chromosome_windowed(options, chrom, reader, ref_id: int,
                             intervals=None, use_device: bool = True,
                             forced_alleles=None, priors=None,
                             reader_factory=None, pipeline_threads: int = 1):
    """Stream one chromosome in window_size slices. Yields
    (result, w_start1, w_end1) per window; counts at in-window positions are
    complete because fetch_region selects reads by overlap, and the margin
    covers spanning-variant endpoint lookups past the window edge.

    With pipeline_threads > 1 and a reader_factory, windows are processed
    on dedicated worker threads (each with its OWN reader handle) while
    earlier windows are being written — the SURVEY M3 "region-tile
    pipelining / input overlap" mechanism. Ordering and bytes are
    unchanged: results are yielded strictly in window order, and every
    handle-tied array is detached inside the worker at trim time
    (copy_positions=True; RefLineBlock blobs are independently owned by
    the native render buffer), so a worker starting its next window
    cannot invalidate an earlier result even before it is written."""
    L = len(chrom.sequence)
    win = options.window_size
    margin = options.window_margin
    windows = [(w0, min(w0 + win, L)) for w0 in range(0, L, win)]

    if pipeline_threads <= 1 or reader_factory is None or len(windows) <= 1:
        for w0, w1 in windows:
            view = _RegionView(reader, ref_id, max(0, w0 - margin),
                               min(L, w1 + margin))
            result = call_chromosome(options, chrom, view, intervals,
                                     use_device, forced_alleles, priors)
            trimmed = _trim_window_result(result, w0, w1,
                                          copy_positions=False)
            yield trimmed, w0 + 1, w1
        return

    from concurrent.futures import ThreadPoolExecutor

    n_workers = min(pipeline_threads, len(windows))
    execs = [ThreadPoolExecutor(max_workers=1) for _ in range(n_workers)]
    local_readers: List = [None] * n_workers

    def work(slot: int, w0: int, w1: int):
        if local_readers[slot] is None:
            local_readers[slot] = reader_factory()
        view = _RegionView(local_readers[slot], ref_id, max(0, w0 - margin),
                           min(L, w1 + margin))
        result = call_chromosome(options, chrom, view, intervals, use_device,
                                 forced_alleles, priors)
        return _trim_window_result(result, w0, w1, copy_positions=True)

    try:
        futures = []
        for i in range(min(n_workers, len(windows))):
            w0, w1 = windows[i]
            futures.append(execs[i % n_workers].submit(work, i % n_workers,
                                                       w0, w1))
        for i in range(len(windows)):
            trimmed = futures[i].result()
            futures[i] = None  # drop the result ref: bounded-memory streaming
            nxt = i + n_workers
            if nxt < len(windows):
                w0, w1 = windows[nxt]
                futures.append(execs[nxt % n_workers].submit(
                    work, nxt % n_workers, w0, w1))
            yield trimmed, windows[i][0] + 1, windows[i][1]
    finally:
        for ex in execs:
            ex.shutdown(wait=True)


def load_priors(path: str, trim_mnv: bool = False):
    """Load known collapsable variants (-PriorsPath) into per-chromosome
    Candidate lists for the collapser (Factory.cs priors + TrimMnvPriors:
    strip the shared leading reference base of padded MNV priors)."""
    from pisces_tpu.io.vcf_read import read_header_and_variants
    from pisces_tpu.pileup.candidates import Candidate

    by_chrom: Dict[str, list] = {}
    _hdr, variants = read_header_and_variants(path)
    for v in variants:
        for alt in v.alt_allele.split(","):
            if alt in (".", "<M>", "*"):
                continue
            pos, ref, a = v.position, v.ref_allele, alt
            if trim_mnv and len(ref) > 1 and len(a) > 1 and ref[0] == a[0]:
                pos, ref, a = pos + 1, ref[1:], a[1:]
            if len(ref) == len(a):
                cat = (AlleleCategory.SNV if len(ref) == 1
                       else AlleleCategory.MNV)
            elif len(ref) > len(a):
                cat = AlleleCategory.DELETION
            else:
                cat = AlleleCategory.INSERTION
            by_chrom.setdefault(v.chrom, []).append(
                Candidate(v.chrom, pos, ref, a, cat))
    return by_chrom


def process_bam(options: PiscesApplicationOptions, bam_path: str,
                genome: Genome, out_vcf: Optional[str] = None,
                use_device: bool = True) -> str:
    options.validate()
    from pisces_tpu.io.native import open_bam
    bam = open_bam(bam_path)
    gvcf = options.vcf_writing_parameters.output_gvcf_file
    if out_vcf is None:
        stem = os.path.basename(bam_path)
        if stem.endswith(".bam"):
            stem = stem[:-4]
        suffix = ".genome.vcf" if gvcf else ".vcf"
        out_dir = options.output_directory or os.path.dirname(bam_path)
        os.makedirs(out_dir, exist_ok=True)
        out_vcf = os.path.join(out_dir, stem + suffix)

    forced_alleles = (load_forced_alleles(options.forced_alleles_paths)
                      if options.forced_alleles_paths else None)
    priors = (load_priors(options.priors_path, options.trim_mnv_priors)
              if options.priors_path else None)

    wcfg = VcfWriterConfig(options, has_forced_gt=bool(forced_alleles))
    # the reference's sample column is the bam file name incl. extension
    # (VcfFileWriter header; cf. shipped expected outputs "PhiX_S3.bam")
    sample = os.path.basename(bam_path)
    bias_writer = None
    amp_bias_writer = None
    if options.output_bias_files:
        from pisces_tpu.io.bias_writers import (
            AmpliconBiasFileWriter, StrandBiasFileWriter,
        )
        bias_writer = StrandBiasFileWriter(out_vcf)
        bias_writer.write_header()
        amp_bias_writer = AmpliconBiasFileWriter(out_vcf)
        amp_bias_writer.write_header()

    with VcfWriter(out_vcf, wcfg, genome.directory, sample,
                   genome.chromosome_lengths, options.command_line) as writer:
        writer.write_header()
        from pisces_tpu.calling.intervals import make_region_mapper
        for chrom_name in genome.chromosome_names:
            if chrom_name not in bam.header.ref_names:
                log(f"skipping {chrom_name}: not in bam")
                continue
            if options.chromosome_filter and chrom_name != options.chromosome_filter:
                continue
            chrom = genome.get_chr_reference(chrom_name)
            intervals = _load_intervals(options, chrom_name)
            t0 = time.time()
            windowed = False
            # windowed mode requires either no intervals, plain-VCF output,
            # or the columnar fast-gVCF path (which folds RegionMapper
            # interval padding into its per-window reference lines)
            fast_eligible = _fast_gvcf_eligible(options, forced_alleles)
            win_ok = intervals is None or not gvcf or fast_eligible
            if options.window_size > 0 and win_ok:
                if os.path.exists(bam_path + ".bai"):
                    # native lazy reader: per-window .bai chunks inflate in
                    # C++ and the overlap filter runs there too, keeping
                    # the native pileup path live under windowed streaming.
                    # Windows pipeline across worker threads (SURVEY M3
                    # input overlap): compute window N+1 while writing N.
                    lazy = open_bam(bam_path, lazy=True)
                    rid = lazy.header.ref_index(chrom_name)
                    windowed = True
                    alleles_all = []
                    # window pipelining measured 2-3x SLOWER on a 2-core
                    # box (GIL + bandwidth contention with the writer);
                    # enable the overlap only when cores are plentiful
                    cores = os.cpu_count() or 1
                    n_pipe = (1 if cores <= 2
                              else max(1, min(2, options.max_num_threads)))
                    for (w_alleles, w_refs), _w0, _w1 in \
                            call_chromosome_windowed(
                                options, chrom, lazy, rid, intervals,
                                use_device, forced_alleles, priors,
                                reader_factory=lambda: open_bam(
                                    bam_path, lazy=True),
                                pipeline_threads=n_pipe):
                        write_spliced(writer, w_alleles, w_refs)
                        alleles_all.extend(w_alleles)
                    alleles = alleles_all
                else:
                    log(f"window mode requested but {bam_path}.bai missing; "
                        "processing whole chromosome", "WARNING")
            if not windowed:
                result = call_chromosome(options, chrom, bam, intervals,
                                         use_device, forced_alleles, priors)
                if isinstance(result, tuple):
                    alleles, ref_lines = result
                    write_spliced(writer, alleles, ref_lines)
                else:
                    alleles = result
                    mapper = make_region_mapper(options, chrom, intervals)
                    writer.write(alleles, mapper)
                    writer.write_remaining(mapper)
            if bias_writer is not None:
                bias_writer.write(alleles)
                amp_bias_writer.write(alleles)
            log(f"Completed processing chr {chrom_name} in "
                f"{time.time() - t0:.2f} secs")
    if bias_writer is not None:
        bias_writer.close()
        amp_bias_writer.close()
    return out_vcf


def _load_intervals(options: PiscesApplicationOptions, chrom_name: str):
    if not options.interval_paths:
        return None
    from pisces_tpu.calling.intervals import ChrIntervalSet, read_picard_intervals
    regions = read_picard_intervals(options.interval_paths[0]).get(chrom_name, [])
    if not regions and not any(
            read_picard_intervals(options.interval_paths[0]).values()):
        return None
    return ChrIntervalSet(regions, chrom_name)


def main(argv=None) -> int:
    from pisces_tpu.apps._pisces_main import (
        _b, _normalize, build_parser, options_from_args,
    )
    raw = list(argv if argv is not None else sys.argv[1:])
    args = build_parser().parse_args(_normalize(raw))
    options = options_from_args(args, raw)
    bam_paths = options.bam_paths
    use_device = args.backend == "jax"
    if use_device:
        from pisces_tpu.utils.device import configure_compile_cache
        configure_compile_cache()

    def execute() -> int:
        from pisces_tpu.utils.metrics import metrics, profiler_trace
        with profiler_trace(args.profiledir):
            code = _execute_inner()
        snap = metrics.report()
        if snap["counters"].get("loci_scored"):
            sec = snap["stages"].get("gvcf_scoring", {}).get("seconds", 0)
            if sec:
                log(f"loci scored/sec: "
                    f"{snap['counters']['loci_scored'] / sec:,.0f}")
        if args.metricsjson:
            metrics.write_json(args.metricsjson)
        return code

    def _execute_inner() -> int:
        genome = Genome(args.genome)
        if _b(args.multihost):
            from pisces_tpu.parallel.multihost import process_bam_multihost
            for bam_path in bam_paths:
                out = process_bam_multihost(options, bam_path, args.genome,
                                            use_device=use_device)
                if out:
                    log(f"wrote {out}")
        elif _b(args.multiprocess) and not _b(args.insidesubprocess):
            from pisces_tpu.parallel.scheduler import (
                process_chromosomes_multiprocess,
            )
            for bam_path in bam_paths:
                out = process_chromosomes_multiprocess(
                    options, bam_path, args.genome, args.max_threads,
                    use_device, resume=_b(args.resume))
                log(f"wrote {out}")
        elif args.max_threads > 1 or len(bam_paths) > 1:
            from pisces_tpu.parallel.scheduler import process_bams_parallel
            outs = process_bams_parallel(options, bam_paths, genome,
                                         args.max_threads, use_device,
                                         thread_by_chr=options.thread_by_chr)
            for out in outs:
                log(f"wrote {out}")
        else:
            out = process_bam(options, bam_paths[0], genome,
                              use_device=use_device)
            log(f"wrote {out}")
        return 0

    from pisces_tpu.utils.app import run_application
    log_dir = args.out or os.path.dirname(os.path.abspath(bam_paths[0]))
    return run_application(args.baselogname or "Pisces", execute, options,
                           log_dir)


if __name__ == "__main__":
    sys.exit(main())
