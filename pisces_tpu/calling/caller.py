"""Allele calling orchestration for one chromosome batch.

Port of the AlleleCaller pipeline (exe/Pisces/Logic/VariantCalling/
AlleleCaller.cs:50-264): collapse -> MNV triage/reallocation -> per-candidate
scoring (coverage, Poisson q-score, strand bias) -> filters -> per-locus
genotyping -> deterministic ordering.

This module operates in whole-chromosome batch mode (the streaming block
protocol of RegionStateManager collapses to a single final Call with
upToPosition=None); the sharded runner re-introduces region batching for
multi-device execution.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu.domain.types import (
    AlleleCategory, DirectionType, FilterType, Genotype, NoiseModel,
    PloidyModel, StrandBiasModel,
)
from pisces_tpu.options import PiscesApplicationOptions
from pisces_tpu.calling.alleles import CalledAllele, map_candidate
from pisces_tpu.calling.collapser import VariantCollapser
from pisces_tpu.calling.mnv_realloc import (
    get_ref_support_from_gapped_mnvs, reallocate_failed_mnvs,
)
from pisces_tpu.calling.repeats import (
    RefSeqStr, compute_indel_repeat_length, rmxn_should_filter,
)
from pisces_tpu.calling.source import AlleleSource
from pisces_tpu.ops import stats
from pisces_tpu.ops.coverage import compute_coverage
from pisces_tpu.pileup.candidates import Candidate
from pisces_tpu.pileup.counts import PileupCounts
from pisces_tpu.utils.metrics import metrics


@dataclass
class CallerConfig:
    """VariantCallerConfig equivalent (AlleleCaller.cs:267-292)."""

    include_reference_calls: bool = True
    min_coverage: int = 10
    min_frequency: float = 0.01
    max_variant_qscore: int = 100
    min_variant_qscore: int = 20
    variant_qscore_filter_threshold: Optional[int] = 30
    no_call_filter_threshold: Optional[float] = 0.6
    amplicon_bias_filter_threshold: Optional[float] = None
    noise_level_used_for_q_scoring: int = 20
    strand_bias_filter_threshold: float = 0.5
    filter_single_strand_variants: bool = False
    strand_bias_model: StrandBiasModel = StrandBiasModel.EXTENDED
    variant_freq_filter: Optional[float] = 0.01
    low_gtq_filter: Optional[int] = None
    indel_repeat_filter: Optional[int] = None
    low_depth_filter: Optional[int] = 10
    rmxn_max_length_repeat: Optional[int] = 5
    rmxn_min_repetitions: Optional[int] = 9
    rmxn_frequency_limit: Optional[float] = 0.35
    noise_model: NoiseModel = NoiseModel.FLAT
    ploidy_model: PloidyModel = PloidyModel.SOMATIC
    # somatic genotyper params
    min_frequency_filter: float = 0.01
    target_lod_frequency: float = 0.01
    min_gq_score: int = 0
    max_gq_score: int = 100
    min_depth_to_genotype: int = 10
    consider_anchor_information: bool = True
    expect_stitched_source: bool = False
    coverage_method: "CoverageMethod" = None  # CoverageMethod.EXACT enables read-spanning coverage
    # device routing for the batched candidate-scoring pass: batches at or
    # above the threshold run on the fused XLA kernel (ops/jax_scoring
    # .score_snv_loci); smaller batches stay on the vectorized f64 host
    # path. The 4096 default predates the GPU and is not measured on it:
    # the crossover where a launch plus a host sync beats the host math is
    # still open. Callers override from the -backend flag (jax by
    # default); integer q outputs are exact either way.
    use_device_candidates: bool = True
    device_batch_threshold: int = 4096
    # >1: candidate batches shard over the (dp, sp) device mesh
    # (parallel/sharding.sharded_score_snv_tuples) instead of one device
    mesh_devices: int = 0
    # -gender: drives per-chromosome ploidy dispatch (sex chromosomes go
    # haploid, GenotypeCreator.GetPloidyForThisChr)
    is_male: Optional[bool] = None
    # per-allele strand-bias component tables (forward/reverse/overall
    # ChanceFalsePos etc.) are only materialized when the bias side files
    # are requested (StrandBiasFileWriter columns)
    need_sb_detail: bool = False

    @classmethod
    def from_options(cls, options: PiscesApplicationOptions) -> "CallerConfig":
        v = options.variant_calling_parameters
        return cls(
            include_reference_calls=options.vcf_writing_parameters.output_gvcf_file,
            min_coverage=v.minimum_coverage,
            min_frequency=v.minimum_frequency,
            max_variant_qscore=v.maximum_variant_qscore,
            min_variant_qscore=v.minimum_variant_qscore,
            variant_qscore_filter_threshold=v.minimum_variant_qscore_filter,
            no_call_filter_threshold=v.no_call_filter_threshold,
            amplicon_bias_filter_threshold=v.amplicon_bias_filter_threshold,
            noise_level_used_for_q_scoring=v.noise_level_used_for_q_scoring,
            strand_bias_filter_threshold=v.strand_bias_acceptance_criteria,
            filter_single_strand_variants=v.filter_out_variants_present_only_one_strand,
            strand_bias_model=v.strand_bias_model,
            variant_freq_filter=max(v.minimum_frequency_filter, v.minimum_frequency),
            low_gtq_filter=v.low_genotype_quality_filter,
            indel_repeat_filter=v.indel_repeat_filter,
            low_depth_filter=v.low_depth_filter,
            rmxn_max_length_repeat=v.rmxn_filter_max_length_repeat,
            rmxn_min_repetitions=v.rmxn_filter_min_repetitions,
            rmxn_frequency_limit=v.rmxn_filter_frequency_limit,
            noise_model=v.noise_model,
            coverage_method=options.coverage_method,
            need_sb_detail=options.output_bias_files,
            device_batch_threshold=int(os.environ.get(
                "PISCES_DEVICE_BATCH_THRESHOLD", "4096")),
            mesh_devices=options.mesh_devices,
            is_male=v.is_male,
            ploidy_model=v.ploidy_model,
            min_frequency_filter=max(v.minimum_frequency_filter, v.minimum_frequency),
            target_lod_frequency=max(v.target_lod_frequency,
                                     max(v.minimum_frequency_filter, v.minimum_frequency)),
            min_gq_score=v.minimum_genotype_qscore,
            max_gq_score=v.maximum_genotype_qscore,
            min_depth_to_genotype=v.minimum_coverage,
            consider_anchor_information=options.tracked_anchor_size > 0,
        )


class _SbSliceView:
    """Per-allele view into a batched strand-bias result dict (the
    StrandBiasFileWriter reads sb[group][stat][0] per allele)."""

    __slots__ = ("_batch", "_i")

    def __init__(self, batch: dict, i: int):
        self._batch = batch
        self._i = i

    def __getitem__(self, key):
        v = self._batch[key]
        if isinstance(v, dict):
            return {k: arr[self._i:self._i + 1] for k, arr in v.items()}
        return v[self._i:self._i + 1]


class AlleleCaller:
    def __init__(self, config: CallerConfig, refseq: np.ndarray,
                 collapser: Optional[VariantCollapser] = None,
                 interval_set=None, read_summaries=None):
        self.config = config
        self.refseq = refseq
        self.refseq_str = RefSeqStr(refseq)
        self.collapser = collapser
        self.interval_set = interval_set
        self.read_summaries = read_summaries
        self.forced_alleles: set = set()
        self.total_num_called = 0
        # loci whose reference allele was suppressed by a coexisting
        # variant (even one later pruned by genotyping) — consumed by the
        # fast-gVCF splice
        self.ref_suppressed_positions: set = set()

    @property
    def total_num_collapsed(self) -> int:
        return 0 if self.collapser is None else self.collapser.total_num_collapsed

    # -- per-variant scoring (ProcessVariant, AlleleCaller.cs:208-234) -------
    #
    # The reference scores one allele at a time inside the per-candidate
    # loop; this build phases the same math so the batch of candidates hits
    # the vectorized/fused kernels once:
    #   phase 1  coverage reconciliation (point coverage gathered columnar
    #            for SNV/reference alleles; spanning semantics per-allele)
    #   phase 2  q-score + strand bias over the whole batch (host f64
    #            vectorized, or the fused XLA kernel for large batches)
    #   phase 3  amplicon bias + filters (host, per-allele string logic)

    def process_variant(self, source: AlleleSource, a: CalledAllele) -> None:
        self.process_variants_batch(source, [a])

    def process_variants_batch(self, source: AlleleSource,
                               alleles: List[CalledAllele]) -> None:
        if not alleles:
            return
        point: List[CalledAllele] = []
        spanning: List[CalledAllele] = []
        for a in alleles:
            if a.category in (AlleleCategory.DELETION, AlleleCategory.MNV,
                              AlleleCategory.INSERTION):
                spanning.append(a)
            else:
                point.append(a)
        if point:
            self._batch_point_coverage(source, point)
        for a in spanning:
            self._compute_spanning_coverage(source, a)

        self._score_batch([a for a in alleles if a.allele_support > 0], source)
        for a in alleles:
            self._apply_filters(a)

    def _compute_spanning_coverage(self, source: AlleleSource,
                                   a: CalledAllele) -> None:
        cfg = self.config
        from pisces_tpu.domain.types import CoverageMethod
        use_exact = (cfg.coverage_method == CoverageMethod.EXACT
                     and self.read_summaries is not None)
        if use_exact:
            from pisces_tpu.ops.exact_coverage import exact_spanning_coverage
            length = (len(a.alt_allele) - 1
                      if a.category == AlleleCategory.INSERTION
                      else len(a.ref_allele) - 1
                      if a.category == AlleleCategory.DELETION
                      else len(a.alt_allele))
            cov_dir, total, ref_sup, sum_bq = exact_spanning_coverage(
                source, self.read_summaries, a.category, a.position, length,
                a.allele_support)
            a.total_coverage = total
            a.coverage_by_direction = cov_dir
            a.reference_support = ref_sup
            a.sum_of_base_quality = sum_bq
            return
        cov = compute_coverage(source, a.category, a.position, a.ref_allele,
                               a.alt_allele, a.allele_support,
                               a.well_anchored_support,
                               cfg.consider_anchor_information)
        a.total_coverage = cov.total_coverage
        a.coverage_by_direction = cov.coverage_by_direction
        a.reference_support = cov.reference_support
        a.num_no_calls = cov.num_no_calls
        a.sum_of_base_quality = cov.sum_of_base_quality
        a.confident_coverage_start = cov.confident_coverage_start
        a.confident_coverage_end = cov.confident_coverage_end
        a.suspicious_coverage_start = cov.suspicious_coverage_start
        a.suspicious_coverage_end = cov.suspicious_coverage_end
        a.unanchored_coverage_weight = cov.unanchored_coverage_weight
        if cov.allele_support_adjustment:
            a.allele_support += cov.allele_support_adjustment

    def _batch_point_coverage(self, source: AlleleSource,
                              alleles: List[CalledAllele]) -> None:
        """Columnar CalculateSinglePoint (CoverageCalculator.cs:49-98) over a
        batch of SNV/reference alleles: one gather from the flat count
        tensors instead of 36 scalar lookups per allele."""
        from pisces_tpu.domain.types import (
            COVERAGE_CONTRIBUTING_ALLELES, AlleleType, get_allele_type,
        )
        cov_alleles = np.array([int(x) for x in COVERAGE_CONTRIBUTING_ALLELES])
        n = len(alleles)
        pos = np.fromiter((a.position for a in alleles), np.int64, n)
        rows = np.atleast_1d(source.pc.pos_index(pos))
        counts, quals = source._flat_counts, source._flat_quals
        safe = np.maximum(rows, 0)
        if len(counts) == 0:
            c = np.zeros((n, counts.shape[1] if counts.ndim > 1 else 6, 3),
                         np.int64)
            qv = np.zeros_like(c, dtype=np.float64)
        else:
            c = counts[safe]
            qv = quals[safe]
            miss = rows < 0
            if miss.any():
                c = np.where(miss[:, None, None], 0, c)
                qv = np.where(miss[:, None, None], 0.0, qv)
        cov_by_dir = c[:, cov_alleles, :].sum(axis=1)   # [n, 3]
        total = cov_by_dir.sum(axis=1)
        # base-quality sums folded in the reference's accumulation order
        # (direction-major, then allele) so f64 rounding matches the scalar
        # path bit for bit (WINDOW noise model consumes this)
        qflat = qv[:, cov_alleles, :].transpose(0, 2, 1).reshape(n, -1)
        sum_bq = np.zeros(n, np.float64)
        for j in range(qflat.shape[1]):
            sum_bq += qflat[:, j]
        num_nc = c[:, int(AlleleType.N), :].sum(axis=1)
        ref_types = np.fromiter(
            (int(get_allele_type(a.ref_allele[0])) for a in alleles),
            np.int64, n)
        ref_sup = c[np.arange(n), ref_types, :].sum(axis=1)

        gapped = source.gapped_mnv_ref_counts
        for i, a in enumerate(alleles):
            t = int(total[i])
            a.total_coverage = t
            a.coverage_by_direction = cov_by_dir[i].astype(np.int64)
            a.num_no_calls = int(num_nc[i])
            a.sum_of_base_quality = float(sum_bq[i])
            a.confident_coverage_start = t
            a.confident_coverage_end = t
            rs = int(ref_sup[i])
            g = gapped.get(a.position, 0) if gapped else 0
            if a.category == AlleleCategory.SNV:
                rs = max(0, rs - g)
            elif a.category == AlleleCategory.REFERENCE and g:
                a.allele_support -= min(g, a.allele_support)
            a.reference_support = rs

    def _score_batch(self, alleles: List[CalledAllele],
                     source: AlleleSource) -> None:
        """Batched q-score + strand bias (phase 2) followed by per-allele
        amplicon bias (phase 3 prologue)."""
        cfg = self.config
        n = len(alleles)
        if n == 0:
            return
        sup = np.fromiter((a.allele_support for a in alleles), np.int64, n)
        cov = np.fromiter((a.total_coverage for a in alleles), np.int64, n)
        sup_by_dir = np.stack([a.support_by_direction for a in alleles]
                              ).astype(np.int64)
        cov_by_dir = np.stack([a.coverage_by_direction for a in alleles]
                              ).astype(np.int64)

        flat_noise = cfg.noise_level_used_for_q_scoring
        if cfg.noise_model == NoiseModel.WINDOW:
            noise = np.full(n, flat_noise, np.int64)
            for i, a in enumerate(alleles):
                if a.total_coverage > 0:
                    noise[i] = int(stats.p_to_q(
                        a.sum_of_base_quality / a.total_coverage))
            q = np.zeros(n, np.int64)
            for nz in np.unique(noise):
                m = noise == nz
                q[m] = stats.compute_variant_qscores(
                    sup[m], cov[m], cfg.max_variant_qscore, int(nz))
            per_allele_noise = noise
        else:
            per_allele_noise = None
            q = None  # computed below (host or device)

        # The Poisson q (regularized incomplete gamma — the FLOP-heavy part)
        # routes to the fused XLA kernel for large batches; its integer
        # output is exact vs the f64 host path (grid-validated in
        # tests/test_candidate_batch.py). Strand bias stays on the host f64
        # path unconditionally: the GATK SB float is emitted verbatim in the
        # VCF and f32 gammainc drifts past 4 decimals in the -30..-80 dB
        # range, which would break byte parity.
        use_device = (cfg.use_device_candidates
                      and n >= cfg.device_batch_threshold
                      and per_allele_noise is None)
        if q is None:
            if use_device:
                q = self._qscore_batch_device(sup_by_dir, cov_by_dir, cov,
                                              flat_noise, n,
                                              [a.reference_support for a in alleles],
                                              [a.num_no_calls for a in alleles])
            else:
                q = stats.compute_variant_qscores(
                    sup, cov, cfg.max_variant_qscore, flat_noise)
        sb = stats.compute_strand_bias(
            sup_by_dir, cov_by_dir, flat_noise, cfg.min_frequency,
            cfg.strand_bias_filter_threshold, int(cfg.strand_bias_model))

        bias_score = sb["bias_score"]
        gatk = sb["gatk_bias_score"]
        acceptable = sb["bias_acceptable"]
        var_both = sb["var_present_on_both_strands"]
        cov_both = sb["cov_present_on_both_strands"]
        need_detail = cfg.need_sb_detail
        for i, a in enumerate(alleles):
            a.noise_level_applied = (int(per_allele_noise[i])
                                     if per_allele_noise is not None
                                     else flat_noise)
            a.variant_qscore = int(q[i])
            a.strand_bias_score = float(bias_score[i])
            a.strand_bias_gatk = float(gatk[i])
            a.strand_bias_acceptable = bool(acceptable[i])
            a.var_present_on_both_strands = bool(var_both[i])
            a.cov_present_on_both_strands = bool(cov_both[i])
            if need_detail:
                a.sb_detail = _SbSliceView(sb, i)

        if cfg.amplicon_bias_filter_threshold is not None:
            from pisces_tpu.ops.amplicon_bias import calculate_amplicon_bias
            for a in alleles:
                if a.category != AlleleCategory.SNV:
                    continue
                support_by_amp = getattr(a, "support_by_amplicon", None) or {}
                cov_by_amp = source.get_amplicon_coverage(a.position)
                ab = calculate_amplicon_bias(
                    support_by_amp, cov_by_amp,
                    cfg.amplicon_bias_filter_threshold, cfg.max_variant_qscore)
                if ab is not None:
                    a.amplicon_bias_detected = ab["bias_detected"]
                    a.amplicon_bias_results = ab["results"]

    def _qscore_batch_device(self, sup_by_dir, cov_by_dir, cov, noise_level,
                             n, ref_support, num_no_calls):
        """Score a large candidate batch through the fused XLA kernel
        (ops/jax_scoring.score_snv_loci), padded to a power-of-two tile;
        returns the integer q-scores (exact vs the host f64 path)."""
        import jax
        from pisces_tpu.ops.jax_scoring import ScoringParams, score_snv_loci
        cfg = self.config
        params = ScoringParams(
            noise_level=noise_level,
            max_variant_qscore=cfg.max_variant_qscore,
            min_variant_qscore=cfg.min_variant_qscore,
            variant_qscore_filter=cfg.variant_qscore_filter_threshold or 0,
            min_frequency=cfg.min_frequency,
            min_frequency_filter=cfg.min_frequency_filter,
            target_lod=cfg.target_lod_frequency,
            min_depth=cfg.min_depth_to_genotype,
            low_depth_filter=cfg.low_depth_filter or 0,
            min_gq=cfg.min_gq_score, max_gq=cfg.max_gq_score,
            sb_acceptance=cfg.strand_bias_filter_threshold,
            no_call_filter=cfg.no_call_filter_threshold or 1.0)
        if cfg.mesh_devices > 1:
            # shard the candidate batch over the (dp, sp) mesh — the mesh
            # analog of per-candidate scoring inside each (bam, chr) job
            from pisces_tpu.parallel.sharding import (
                get_mesh, sharded_score_snv_tuples,
            )
            out = sharded_score_snv_tuples(
                sup_by_dir, cov_by_dir, ref_support, num_no_calls, cov,
                params, get_mesh(cfg.mesh_devices))
            metrics.count("device_rows_snv_loci", n)
            return out["variant_qscore"][:n].astype(np.int64)
        pad = max(128, 1 << (n - 1).bit_length())
        sup_p = np.zeros((pad, 3), np.int32)
        cov_p = np.zeros((pad, 3), np.int32)
        tot_p = np.zeros(pad, np.int32)
        ref_p = np.zeros(pad, np.int32)
        nc_p = np.zeros(pad, np.int32)
        sup_p[:n] = sup_by_dir
        cov_p[:n] = cov_by_dir
        tot_p[:n] = cov
        ref_p[:n] = ref_support
        nc_p[:n] = num_no_calls
        out = score_snv_loci(jax.device_put(sup_p), jax.device_put(cov_p),
                             jax.device_put(ref_p), jax.device_put(nc_p),
                             jax.device_put(tot_p), params)
        q = np.asarray(out["variant_qscore"])[:n].astype(np.int64)
        metrics.count("device_rows_snv_loci", n)
        return q

    def _apply_filters(self, a: CalledAllele) -> None:
        """AlleleProcessor.Process/ApplyFilters (AlleleProcessor.cs:16-71)."""
        cfg = self.config
        a.set_fraction_no_calls()
        a.filters = []
        if cfg.low_depth_filter is not None and a.total_coverage < cfg.low_depth_filter:
            a.add_filter(FilterType.LOW_DEPTH)
        if (cfg.variant_qscore_filter_threshold is not None
                and a.variant_qscore < cfg.variant_qscore_filter_threshold
                and a.total_coverage != 0):
            a.add_filter(FilterType.LOW_VARIANT_QSCORE)
        if a.category != AlleleCategory.REFERENCE:
            if (cfg.no_call_filter_threshold is not None
                    and a.fraction_no_calls > cfg.no_call_filter_threshold):
                a.add_filter(FilterType.NO_CALL)
            if (not a.strand_bias_acceptable
                    or (cfg.filter_single_strand_variants
                        and not a.var_present_on_both_strands)):
                a.add_filter(FilterType.STRAND_BIAS)
            if (a.amplicon_bias_detected
                    and cfg.amplicon_bias_filter_threshold is not None):
                a.add_filter(FilterType.AMPLICON_BIAS)
            if cfg.indel_repeat_filter is not None and cfg.indel_repeat_filter > 0:
                rep = compute_indel_repeat_length(a.category, a.position,
                                                  a.ref_allele, a.alt_allele,
                                                  self.refseq)
                if cfg.indel_repeat_filter <= rep:
                    a.add_filter(FilterType.INDEL_REPEAT_LENGTH)
            if rmxn_should_filter(a.category, a.position, a.ref_allele, a.alt_allele,
                                  a.frequency, self.refseq_str,
                                  cfg.rmxn_max_length_repeat,
                                  cfg.rmxn_min_repetitions,
                                  cfg.rmxn_frequency_limit):
                a.add_filter(FilterType.RMXN)
            if (cfg.variant_freq_filter is not None
                    and np.float32(a.frequency) < np.float32(cfg.variant_freq_filter)):
                a.add_filter(FilterType.LOW_VARIANT_FREQUENCY)
            if cfg.expect_stitched_source and "N" in a.alt_allele:
                a.add_filter(FilterType.STRAND_BIAS)

    # -- callability (AlleleCaller.cs:236-258) -------------------------------

    def _is_callable(self, a: CalledAllele) -> bool:
        cfg = self.config
        if a.category == AlleleCategory.REFERENCE:
            self.total_num_called += 1
            return True
        if a.total_coverage < cfg.min_coverage and not cfg.include_reference_calls:
            return False
        if (a.total_coverage != 0
                and np.float32(a.frequency) < np.float32(cfg.min_frequency)):
            return False
        if a.variant_qscore < cfg.min_variant_qscore:
            return False
        self.total_num_called += 1
        return True

    def _should_report(self, a: CalledAllele) -> bool:
        if self.interval_set is None:
            return True
        return self.interval_set.contains(a.position)

    def _is_forced(self, a: CalledAllele) -> bool:
        return (a.chromosome, a.position, a.ref_allele, a.alt_allele) in self.forced_alleles

    # -- genotyping (somatic; diploid/haploid/adaptive in genotype/) ---------

    def _set_genotypes(self, alleles: List[CalledAllele]) -> List[CalledAllele]:
        from pisces_tpu.genotype import create_genotype_calculator
        calc = create_genotype_calculator(self.config, alleles[0].chromosome
                                          if alleles else None,
                                          is_male=self.config.is_male)
        return calc.set_genotypes(alleles)

    # -- main entry -----------------------------------------------------------

    def call(self, candidates: List[Candidate], source: AlleleSource,
             max_position: Optional[int] = None
             ) -> Dict[int, List[CalledAllele]]:
        """CallForPositions: returns {position: [alleles sorted by ref,alt]}."""
        cfg = self.config
        failed_mnvs: List[CalledAllele] = []
        callable_alleles: List[CalledAllele] = []
        leftover: List[Candidate] = []

        if self.collapser is not None:
            candidates = self.collapser.collapse(list(candidates), source,
                                                 max_position)
            leftover = self.collapser.not_cleared

        mapped = [map_candidate(cand) for cand in candidates]
        self.process_variants_batch(
            source, [v for v in mapped if v.category == AlleleCategory.MNV])
        for variant in mapped:
            if variant.category == AlleleCategory.MNV:
                if self._is_callable(variant):
                    callable_alleles.append(variant)
                else:
                    failed_mnvs.append(variant)
            else:
                callable_alleles.append(variant)

        spilled = reallocate_failed_mnvs(failed_mnvs, callable_alleles, max_position)
        # spilled alleles re-enter the next region's candidate pool
        self.spilled_next_region = spilled

        source.add_gapped_mnv_ref_counts(
            get_ref_support_from_gapped_mnvs(callable_alleles))

        for failed in failed_mnvs:
            if self._is_forced(failed):
                callable_alleles.append(failed)

        by_position: Dict[int, List[CalledAllele]] = {}
        self.process_variants_batch(source, callable_alleles)
        for a in callable_alleles:
            if self._is_forced(a) and not (self._is_callable(a) and self._should_report(a)):
                a.is_forced_to_report = True
                a.add_filter(FilterType.FORCED_REPORT)
            if (self._is_callable(a) and self._should_report(a)) or self._is_forced(a):
                by_position.setdefault(a.position, []).append(a)

        # somatic GT/GQ is elementwise per allele (SomaticGenotyper never
        # prunes and has no cross-allele state), so one batched numpy pass
        # over every locus replaces 1-allele-per-call dispatch; diploid
        # models keep the per-locus path (multi-allelic pruning is
        # locus-coupled)
        batched_gt = (cfg.ploidy_model == PloidyModel.SOMATIC
                      and bool(by_position))
        if batched_gt:
            flat = [a for pos in by_position for a in by_position[pos]
                    if not a.is_forced_to_report]
            if flat:
                self._set_genotypes(flat)
        for pos in by_position:
            alleles_at_pos = by_position[pos]
            self._compute_genotype_and_filter(alleles_at_pos,
                                              gt_precomputed=batched_gt)
            self._locus_process(alleles_at_pos)

        return dict(sorted(by_position.items()))

    def _compute_genotype_and_filter(self, alleles: List[CalledAllele],
                                     gt_precomputed: bool = False) -> None:
        """ComputeGenotypeAndFilterAllele (AlleleCaller.cs:143-180)."""
        if any(a.category != AlleleCategory.REFERENCE and not a.is_forced_to_report
               for a in alleles):
            # the locus's reference allele is suppressed even if genotyping
            # later prunes every variant here (diploid sub-threshold case):
            # record it so the fast-gVCF splice drops the ref line too
            if alleles:
                self.ref_suppressed_positions.add(alleles[0].position)
            alleles[:] = [a for a in alleles if a.category != AlleleCategory.REFERENCE]

        if not gt_precomputed:
            to_prune = self._set_genotypes(
                [a for a in alleles if not a.is_forced_to_report])
            for p in to_prune:
                key = (p.chromosome, p.position, p.ref_allele, p.alt_allele)
                if key not in self.forced_alleles:
                    alleles.remove(p)

        if self.config.low_gtq_filter is not None:
            for a in alleles:
                if a.genotype_qscore < self.config.low_gtq_filter:
                    a.add_filter(FilterType.LOW_GENOTYPE_QUALITY)

        alleles.sort(key=lambda a: (a.ref_allele, a.alt_allele))

    def _locus_process(self, alleles: List[CalledAllele]) -> None:
        """Somatic locus processor is a no-op; diploid handles forced alleles
        (DiploidLocusProcessor.cs:539-577)."""
        if self.config.ploidy_model != PloidyModel.DIPLOID_BY_THRESHOLDING:
            return
        forced = [a for a in alleles if FilterType.FORCED_REPORT in a.filters]
        non_forced = [a for a in alleles if FilterType.FORCED_REPORT not in a.filters]
        if not forced:
            return
        is_ref = any(a.is_ref_type for a in non_forced)
        is_nocall = (not non_forced) or any(a.is_nocall for a in non_forced)
        gt = (Genotype.ALT_LIKE_NOCALL if is_nocall
              else (Genotype.HOMOZYGOUS_REF if is_ref else Genotype.OTHERS))
        for a in forced:
            a.genotype = gt
        min_gq = 0 if not non_forced else min(a.genotype_qscore for a in non_forced)
        for a in alleles:
            a.genotype_qscore = min_gq


def make_reference_candidates(chrom: str, refseq: np.ndarray, pc: PileupCounts,
                              intervals=None) -> List[Candidate]:
    """gVCF reference-allele synthesis from count tensors
    (RegionState.GetAllCandidates, cs:383-460), vectorized per block."""
    from pisces_tpu.domain.types import BASE_TO_ALLELE
    out: List[Candidate] = []
    nb = len(pc.block_keys)
    if nb == 0:
        return out
    counts_t = pc.counts_t               # [NB, B, 6, 3]
    total_support = counts_t.sum(axis=(2, 3))  # [NB, B]
    for bi in range(nb):
        key = int(pc.block_keys[bi])
        start = (key - 1) * pc.block_size + 1
        end = key * pc.block_size
        if intervals is not None:
            ranges = intervals.clipped_ranges(start, end)
        else:
            ranges = [(start, end)]
        for (rs, re_) in ranges:
            positions = np.arange(rs, re_ + 1, dtype=np.int64)
            positions = positions[positions <= len(refseq)]
            if len(positions) == 0:
                continue
            in_block = positions - start
            ref_bytes = refseq[positions - 1]
            ref_codes = BASE_TO_ALLELE[ref_bytes]
            sup = total_support[bi, in_block]
            if intervals is None:
                sel = sup > 0
            else:
                sel = np.ones(len(positions), dtype=bool)
            for pos, code, rb, ib in zip(positions[sel], ref_codes[sel],
                                         ref_bytes[sel], in_block[sel]):
                c = Candidate(chrom, int(pos), chr(rb), chr(rb),
                              AlleleCategory.REFERENCE)
                c.support_by_direction = counts_t[bi, ib, code, :].astype(np.int64)
                out.append(c)
    return out
