"""Configuration tree with reference-identical names and defaults.

Mirrors the reference option objects so output parity is achievable:
  - VariantCallingParameters (src/lib/Pisces.Domain/Options/VariantCallingParameters.cs:57-107)
  - BamFilterParameters      (src/lib/Pisces.Domain/Options/BamFilterParameters.cs:6-12)
  - VcfWritingParameters     (src/lib/Pisces.Domain/Options/VcfWritingParameters.cs:5-18)
  - PiscesApplicationOptions (src/lib/Pisces.Domain/Options/PiscesApplicationOptions.cs:18-67)
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from pisces_tpu.domain.types import (
    CoverageMethod,
    NoiseModel,
    PloidyModel,
    StrandBiasModel,
)

REGION_SIZE = 1000  # reference: PiscesApplicationOptions.cs:21 (GlobalConstants.RegionSize)


@dataclass
class DiploidThresholdingParameters:
    minor_vf: float = 0.20
    major_vf: float = 0.70
    sum_vf_for_multi_allelic_site: float = 0.80


@dataclass
class AdaptiveGenotypingParameters:
    sum_vf_for_multi_allelic_site: float = 0.80
    max_genotype_posteriors: int = 3000
    snv_model: tuple = (0.037, 0.439, 0.976)
    indel_model: tuple = (0.037, 0.443, 0.905)
    snv_prior: tuple = (0.755, 0.154, 0.0919)
    indel_prior: tuple = (0.962, 0.0266, 0.0114)


@dataclass
class BamFilterParameters:
    minimum_map_quality: int = 1
    minimum_base_call_quality: int = 20
    min_number_variants_in_read: int = 1  # Scylla only
    remove_duplicates: bool = True
    only_use_proper_pairs: bool = False


@dataclass
class VariantCallingParameters:
    minimum_frequency: float = 0.01
    minimum_frequency_filter: float = -1.0  # raised to minimum_frequency in validate()
    target_lod_frequency: float = -1.0      # raised to minimum_frequency_filter in validate()

    maximum_variant_qscore: int = 100
    minimum_variant_qscore: int = 20
    minimum_variant_qscore_filter: int = 30

    maximum_genotype_qscore: int = 100
    minimum_genotype_qscore: int = 0
    low_genotype_quality_filter: Optional[int] = None

    minimum_coverage: int = 10
    low_depth_filter: Optional[int] = None

    indel_repeat_filter: Optional[int] = None

    rmxn_filter_max_length_repeat: Optional[int] = 5
    rmxn_filter_min_repetitions: Optional[int] = 9
    rmxn_filter_frequency_limit: float = 0.35

    ploidy_model: PloidyModel = PloidyModel.SOMATIC
    adaptive_genotyping_parameters: AdaptiveGenotypingParameters = field(
        default_factory=AdaptiveGenotypingParameters)
    diploid_snv_thresholding_parameters: DiploidThresholdingParameters = field(
        default_factory=DiploidThresholdingParameters)
    diploid_indel_thresholding_parameters: DiploidThresholdingParameters = field(
        default_factory=DiploidThresholdingParameters)

    is_male: Optional[bool] = None

    forced_noise_level: int = -1
    noise_level_used_for_q_scoring: int = 20  # derived
    noise_model: NoiseModel = NoiseModel.FLAT

    strand_bias_acceptance_criteria: float = 0.5
    strand_bias_model: StrandBiasModel = StrandBiasModel.EXTENDED
    filter_out_variants_present_only_one_strand: bool = False

    no_call_filter_threshold: float = 0.6
    amplicon_bias_filter_threshold: Optional[float] = None

    def validate(self, bam_filter: BamFilterParameters) -> None:
        """Derived-parameter resolution (reference: VariantCallingParameters.Validate)."""
        if self.maximum_variant_qscore < self.minimum_variant_qscore:
            raise ValueError("MinimumVariantQScore must be <= MaximumVariantQScore")
        if self.low_depth_filter is None or self.low_depth_filter < self.minimum_coverage:
            self.low_depth_filter = self.minimum_coverage
        if self.minimum_frequency_filter < self.minimum_frequency:
            self.minimum_frequency_filter = self.minimum_frequency
        if self.target_lod_frequency < self.minimum_frequency_filter:
            self.target_lod_frequency = self.minimum_frequency_filter
        self.noise_level_used_for_q_scoring = (
            bam_filter.minimum_base_call_quality
            if self.forced_noise_level == -1
            else self.forced_noise_level
        )
        if (self.rmxn_filter_max_length_repeat is None) != (self.rmxn_filter_min_repetitions is None):
            raise ValueError("RMxN filter requires both M and N or neither")


@dataclass
class VcfWritingParameters:
    output_gvcf_file: bool = True
    force_crush: Optional[bool] = None
    allow_multiple_vcf_lines_per_loci: bool = True  # derived from ploidy
    report_no_calls: bool = False
    report_rc_counts: bool = False
    report_ts_counts: bool = False
    report_gp: bool = False
    strand_bias_score_minimum_to_write_to_vcf: float = -100.0
    strand_bias_score_maximum_to_write_to_vcf: float = 0.0
    report_suspicious_coverage_fraction: bool = False

    def set_derived_parameters(self, varcall: VariantCallingParameters) -> None:
        if varcall.ploidy_model in (PloidyModel.DIPLOID_BY_THRESHOLDING,
                                    PloidyModel.DIPLOID_BY_ADAPTIVE_GT):
            self.allow_multiple_vcf_lines_per_loci = False
        else:
            self.allow_multiple_vcf_lines_per_loci = True
        if self.force_crush is not None:
            self.allow_multiple_vcf_lines_per_loci = not self.force_crush
        if varcall.ploidy_model == PloidyModel.DIPLOID_BY_ADAPTIVE_GT:
            self.report_gp = True


@dataclass
class PiscesApplicationOptions:
    """Top-level application options (reference: PiscesApplicationOptions.cs)."""

    bam_paths: List[str] = field(default_factory=list)
    genome_paths: List[str] = field(default_factory=list)
    interval_paths: List[str] = field(default_factory=list)
    forced_alleles_paths: List[str] = field(default_factory=list)
    output_directory: Optional[str] = None

    call_mnvs: bool = False
    max_size_mnv: int = 3
    max_gap_between_mnv: int = 1
    collapse: bool = True
    exclude_mnvs_from_collapsing: bool = False
    collapse_freq_threshold: float = 0.0
    collapse_freq_ratio_threshold: float = 0.5
    use_stitched_xd_info: bool = False
    tracked_anchor_size: int = 5
    output_bias_files: bool = False
    thread_by_chr: bool = False
    max_num_threads: int = 20
    chromosome_filter: Optional[str] = None
    coverage_method: CoverageMethod = CoverageMethod.APPROXIMATE
    debug_mode: bool = False
    priors_path: Optional[str] = None       # vcf of known variants to force
    trim_mnv_priors: bool = False
    # extension of this rebuild: process chromosomes in fixed-size windows via the
    # .bai index so WGS-scale inputs stream with bounded memory (0 = off)
    window_size: int = 0
    window_margin: int = 2000
    # extension of this rebuild: shard the dense per-locus scoring over an
    # N-device (dp, sp) mesh with read-routing + ppermute halo exchange
    # (parallel/sharding.py); 0/1 = single-device
    mesh_devices: int = 0
    # extension of this rebuild: columnar gVCF reference-line path (calling/
    # fast_gvcf.py); False forces the per-candidate object path (the
    # byte-parity oracle the fast path is tested against)
    use_fast_gvcf: bool = True

    bam_filter_parameters: BamFilterParameters = field(default_factory=BamFilterParameters)
    variant_calling_parameters: VariantCallingParameters = field(
        default_factory=VariantCallingParameters)
    vcf_writing_parameters: VcfWritingParameters = field(default_factory=VcfWritingParameters)

    command_line: str = ""

    # extensions of this rebuild
    scoring_backend: str = "jax"  # "jax" (device, batched) or "numpy" (host, f64 parity)

    def validate(self) -> None:
        # PiscesApplicationOptions.SetDerivedParameters (cs:73-80): thread
        # count is clamped to the machine's core count — oversubscribing a
        # small box degrades wall-clock (measured 2.5x worse at 4 threads
        # on 2 cores).
        cores = os.cpu_count() or 1
        if self.max_num_threads > 0:
            self.max_num_threads = min(cores, self.max_num_threads)
        self.variant_calling_parameters.validate(self.bam_filter_parameters)
        self.vcf_writing_parameters.set_derived_parameters(self.variant_calling_parameters)

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return str(o)
        return json.dumps(dataclasses.asdict(self), default=enc, indent=2)
