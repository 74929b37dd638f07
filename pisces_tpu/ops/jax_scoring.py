"""Fused per-locus scoring kernels (JAX/XLA device path).

The dense gVCF hot path of the reference — per-position coverage totals,
Poisson q-score, strand bias, somatic genotype + GQ, filter bitmask
(CoverageCalculator / VariantQualityCalculator / StrandBiasCalculator /
SomaticGenotyper semantics) — expressed as one fused elementwise pass over a
padded batch of loci, so XLA compiles it into a few elementwise kernels.

The math mirrors the f64 host backend (ops/stats.py) operation for
operation, including its dtypes: float64 wherever the host computes in
double, float32 wherever the host (and the reference) rounds through
float. In float32 throughout, `trunc(k + 1)` of a float32 `k` just below
an integer rounds up where the host's double does not, and `1 - CDF` in
the strand-bias terms cancels to zero long before it does in double: both
change integer GQs and printed SB values. So the kernels run in float64,
which needs `jax_enable_x64` while they are traced. Each entry point
enables it for its own call; a caller that nests an entry point inside
its own jit or shard_map enables it around that outer call instead
(`jax.enable_x64(True)`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaincc, gammaln

from pisces_tpu.domain.types import AlleleType, Genotype
# ScoringParams and the filter-bit constants live in the jax-free
# ops/scoring_params module (host cold-start); re-exported here for the
# device-path callers
from pisces_tpu.ops.scoring_params import (  # noqa: F401
    FILTER_BIT_LOW_DEPTH, FILTER_BIT_LOW_VARIANT_QSCORE,
    FILTER_BIT_STRAND_BIAS, FILTER_BIT_LOW_VARIANT_FREQUENCY,
    FILTER_BIT_NO_CALL, ScoringParams,
)

LN10 = 2.302585092994046
_F64 = jnp.float64
_F32 = jnp.float32
_COV_ALLELES = (int(AlleleType.A), int(AlleleType.C), int(AlleleType.G),
                int(AlleleType.T), int(AlleleType.DELETION))


def _x64_kernel(fn):
    """jit `fn` (params static) and run every call with float64 enabled."""
    jitted = jax.jit(fn, static_argnames=("params",))

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with jax.enable_x64(True):
            return jitted(*args, **kwargs)

    call.jitted = jitted
    return call


def q_to_p(q):
    return jnp.power(_F64(10.0), -jnp.asarray(q, _F64) / 10.0)


def poisson_cdf(k, lam):
    """P(X <= floor(k)); matches host stats.poisson_cdf (upper gamma),
    including its -1 for a <= 0."""
    a = jnp.trunc(k.astype(_F64) + 1.0)
    out = gammaincc(jnp.maximum(a, 1e-300), jnp.maximum(lam.astype(_F64),
                                                          0.0))
    return jnp.where(a <= 0, -1.0, out)


def poisson_qscores(call_count, coverage, noise_level, max_qscore):
    """Integer Poisson q-scores (stats.assign_poisson_qscore): p = 1 - CDF
    by literal subtraction, with the log-pmf fallback once p cancels to 0,
    clamped to [0, max] and rounded half to even."""
    cc = call_count.astype(_F64)
    cov = coverage.astype(_F64)
    lam = _error_rate(noise_level) * cov
    p = 1.0 - gammaincc(jnp.maximum(cc, 1e-300), lam)
    q_direct = -10.0 * jnp.log10(jnp.where(p > 0, p, 1.0))

    k = cc - 1.0
    log_pmf = k * jnp.log(jnp.maximum(lam, 1e-300)) - lam - gammaln(k + 1.0)
    corr = (cc - lam) / jnp.maximum(cc, 1e-300)
    q_fallback = (-10.0 * (log_pmf - jnp.log(jnp.maximum(2.0 * corr, 1e-300)))
                  / LN10)
    q = jnp.where(p > 0, q_direct, q_fallback)
    q = jnp.maximum(jnp.minimum(_F64(max_qscore), q), 0.0)
    iq = jnp.round(q).astype(jnp.int32)
    return jnp.where((call_count <= 0) | (coverage <= 0), 0, iq)


def _sb_stats(support, coverage, noise_freq):
    """Extended-model PopulateStats: returns (cfp, cvfgz)."""
    support = support.astype(_F64)
    coverage = coverage.astype(_F64)
    zero = support == 0
    z_cvfgz = jnp.power(1.0 - noise_freq, coverage)
    nz_cvfgz = jnp.maximum(0.0, poisson_cdf(support - 1.0,
                                            coverage * noise_freq))
    cvfgz = jnp.where(zero, z_cvfgz, nz_cvfgz)
    cfp = jnp.where(zero, 1.0 - z_cvfgz, jnp.maximum(0.0, 1.0 - nz_cvfgz))
    return cfp, cvfgz


def strand_bias(support_by_dir, coverage_by_dir, noise_level, acceptance):
    """Extended-model strand bias over [.., 3] arrays
    (stats.compute_strand_bias).

    Returns (bias_score, gatk_score, acceptable, var_both, cov_both).
    """
    noise_freq = _error_rate(noise_level)
    sup = support_by_dir.astype(jnp.int32)
    cov = coverage_by_dir.astype(jnp.int32)
    fs, rs, ss = sup[..., 0], sup[..., 1], sup[..., 2]
    fc, rc, sc = cov[..., 0], cov[..., 1], cov[..., 2]
    fw_s, fw_c = fs + ss // 2, fc + sc // 2
    rv_s, rv_c = rs + ss // 2, rc + sc // 2

    _ov_cfp, ov_cvfgz = _sb_stats(fs + rs + ss, fc + rc + sc, noise_freq)
    fw_cfp, fw_cvfgz = _sb_stats(fw_s, fw_c, noise_freq)
    rv_cfp, rv_cvfgz = _sb_stats(rv_s, rv_c, noise_freq)

    degenerate = ov_cvfgz == 0
    denom = jnp.where(degenerate, 1.0, ov_cvfgz)
    fwd = jnp.where(degenerate, 1.0, fw_cvfgz * rv_cfp / denom)
    rev = jnp.where(degenerate, 1.0, rv_cvfgz * fw_cfp / denom)
    score = jnp.maximum(fwd, rev)
    gatk = jnp.where(score == 0, -jnp.inf,
                     10.0 * jnp.log10(jnp.where(score == 0, 1.0, score)))

    cov_both = (fw_c > 0) & (rv_c > 0)
    var_both = (fw_s > 0) & (rv_s > 0)
    score = jnp.where(cov_both, score, 0.0)
    gatk = jnp.where(cov_both, gatk, -jnp.inf)
    acceptable = score < acceptance
    return score, gatk, acceptable, var_both, cov_both


def _frequency(support, total_coverage):
    """float32 allele frequency, 0 without coverage (host semantics).

    The quotient is taken in float64 and rounded once to float32, which
    gives the correctly rounded float32 quotient. The GPU's own float32
    division is not correctly rounded, and one ulp of frequency moves
    trunc((1 - f) * coverage) in the GQ across an integer."""
    f = support.astype(_F64) / jnp.maximum(total_coverage, 1).astype(_F64)
    return jnp.where(total_coverage == 0, _F32(0.0),
                     jnp.minimum(f, 1.0).astype(_F32))


def _error_rate(noise_level: int) -> float:
    """Phred noise level -> error rate, on the host: `noise_level` is static,
    and the host's pow gives the bits ops/stats.py uses."""
    return 10.0 ** (-noise_level / 10.0)


def somatic_genotypes(is_reference, frequency, ref_frequency, total_coverage,
                      min_freq_filter, min_depth):
    f_min = _F32(min_freq_filter)
    one = _F32(1.0)
    gt = jnp.full(frequency.shape, int(Genotype.HOMOZYGOUS_REF), jnp.int32)
    var_homalt = (ref_frequency < f_min) & ~((one - frequency) > f_min)
    var_altno = (ref_frequency < f_min) & ((one - frequency) > f_min)
    gt = jnp.where(~is_reference,
                   jnp.where(var_altno, int(Genotype.ALT_AND_NOCALL),
                             jnp.where(var_homalt, int(Genotype.HOMOZYGOUS_ALT),
                                       int(Genotype.HETEROZYGOUS_ALT_REF))), gt)
    gt = jnp.where(is_reference & (frequency < f_min),
                   int(Genotype.REF_LIKE_NOCALL), gt)
    gt = jnp.where(is_reference & ~(frequency < f_min)
                   & ((one - frequency) > f_min),
                   int(Genotype.REF_AND_NOCALL), gt)
    low = total_coverage < min_depth
    gt = jnp.where(low & is_reference, int(Genotype.REF_LIKE_NOCALL), gt)
    gt = jnp.where(low & ~is_reference, int(Genotype.ALT_LIKE_NOCALL), gt)
    return gt


def somatic_gq(genotype, variant_qscore, frequency, total_coverage,
               target_lod, min_gq, max_gq):
    """stats.somatic_genotype_qscores: float32 non-allele/expected counts
    (the reference's float intermediates), float64 probabilities."""
    cov_f = total_coverage.astype(_F32)
    is_hom = ((genotype == int(Genotype.HOMOZYGOUS_REF))
              | (genotype == int(Genotype.HOMOZYGOUS_ALT)))
    non_allele = (_F32(1.0) - frequency) * cov_f
    expected = _F32(target_lod) * cov_f
    p1 = q_to_p(variant_qscore)
    p2 = poisson_cdf(non_allele, expected)
    hom_q = -10.0 * jnp.log10(jnp.maximum(p1 + p2, 1e-300))
    hom_q = jnp.where(non_allele >= expected, _F64(min_gq), hom_q)
    raw = jnp.where(is_hom, hom_q, variant_qscore.astype(_F64))
    q = jnp.maximum(jnp.minimum(_F64(max_gq), raw), _F64(min_gq))
    iq = jnp.round(q).astype(jnp.int32)
    nocall = ((genotype == int(Genotype.ALT12_LIKE_NOCALL))
              | (genotype == int(Genotype.ALT_LIKE_NOCALL))
              | (genotype == int(Genotype.HEMIZYGOUS_NOCALL))
              | (genotype == int(Genotype.REF_LIKE_NOCALL)))
    return jnp.where((total_coverage == 0) | nocall, min_gq, iq)


def _score_reference_tuples(support_by_dir, cov_by_dir, params: ScoringParams):
    """Fused gVCF reference scoring from per-locus direction tuples.

    Every output of the reference-locus kernel is a pure function of the
    (support_by_dir, coverage_by_dir) 6-tuple, so callers can deduplicate
    loci to unique tuples on the host, score U << L rows here, and scatter
    back — shrinking both device work and device->host readback
    (fast_gvcf.score_reference_positions does exactly this).
    """
    support_by_dir = support_by_dir.astype(jnp.int32)
    cov_by_dir = cov_by_dir.astype(jnp.int32)
    total_cov = cov_by_dir.sum(axis=-1)
    support = support_by_dir.sum(axis=-1)

    q = poisson_qscores(support, total_cov, params.noise_level,
                        params.max_variant_qscore)
    q = jnp.where((total_cov == 0) | (support <= 0), 0, q)
    freq = _frequency(support, total_cov)

    _score, sb_gatk, _ok, _var_both, _cov_both = strand_bias(
        support_by_dir, cov_by_dir, params.noise_level, params.sb_acceptance)
    # strand bias only computed when support > 0 (ProcessVariant gate);
    # otherwise C# defaults: gatk 0.0, acceptable False (unused for refs)
    sb_gatk = jnp.where(support > 0, sb_gatk, 0.0)

    is_ref = jnp.ones_like(total_cov, dtype=bool)
    gt = somatic_genotypes(is_ref, freq, freq, total_cov,
                           params.min_frequency_filter, params.min_depth)
    gq = somatic_gq(gt, q, freq, total_cov, params.target_lod,
                    params.min_gq, params.max_gq)

    filter_bits = jnp.zeros_like(total_cov, dtype=jnp.int32)
    filter_bits |= jnp.where(total_cov < params.low_depth_filter,
                             1 << FILTER_BIT_LOW_DEPTH, 0)
    filter_bits |= jnp.where((q < params.variant_qscore_filter) & (total_cov != 0),
                             1 << FILTER_BIT_LOW_VARIANT_QSCORE, 0)

    return {
        "total_coverage": total_cov,
        "support": support,
        "support_by_dir": support_by_dir,
        "coverage_by_dir": cov_by_dir,
        "frequency": freq,
        "variant_qscore": q,
        "genotype": gt,
        "gq": gq,
        "sb_gatk": sb_gatk,
        "filter_bits": filter_bits,
    }


score_reference_tuples = _x64_kernel(_score_reference_tuples)


@_x64_kernel
def score_reference_loci(counts, ref_code, params: ScoringParams):
    """Fused gVCF reference-locus scoring over a padded tile.

    Args:
      counts: int32 [L, 6, 3, K] pileup counts (anchor axis K intact)
      ref_code: int8/int32 [L] reference-base allele codes
      params: static ScoringParams
    Returns dict of [L] arrays: total_coverage, support, num_no_calls,
      variant_qscore, genotype, gq, sb_gatk, filter_bits, coverage_by_dir,
      support_by_dir.
    """
    c = counts.sum(axis=-1)  # [L, 6, 3]
    cov_alleles = jnp.array(_COV_ALLELES)
    cov_by_dir = c[:, cov_alleles, :].sum(axis=1)  # [L, 3]
    l_idx = jnp.arange(c.shape[0])
    support_by_dir = c[l_idx, ref_code.astype(jnp.int32), :]  # [L, 3]
    out = dict(_score_reference_tuples(support_by_dir, cov_by_dir, params))
    out["num_no_calls"] = c[:, int(AlleleType.N), :].sum(axis=-1)
    return out


@_x64_kernel
def score_snv_loci(support_by_dir, cov_by_dir, ref_support, num_no_calls,
                   total_coverage, params: ScoringParams):
    """Fused SNV-candidate scoring over a padded batch.

    Inputs are gathered host-side from the aggregated candidates + count
    tensors (single-point coverage semantics); this kernel fuses q-score,
    strand bias, genotype, GQ and the dense filter bits.
    """
    support = support_by_dir.sum(axis=-1)
    q = poisson_qscores(support, total_coverage, params.noise_level,
                        params.max_variant_qscore)
    q = jnp.where((total_coverage == 0) | (support <= 0), 0, q)
    freq = _frequency(support, total_coverage)
    ref_freq = _frequency(ref_support, total_coverage)
    sb_score, sb_gatk, sb_ok, var_both, cov_both = strand_bias(
        support_by_dir, cov_by_dir, params.noise_level, params.sb_acceptance)
    is_ref = jnp.zeros_like(total_coverage, dtype=bool)
    gt = somatic_genotypes(is_ref, freq, ref_freq, total_coverage,
                           params.min_frequency_filter, params.min_depth)
    gq = somatic_gq(gt, q, freq, total_coverage, params.target_lod,
                    params.min_gq, params.max_gq)

    # CalledAllele.set_fraction_no_calls, in double
    all_reads = (total_coverage + num_no_calls).astype(_F64)
    frac_nc = jnp.where(all_reads == 0, 0.0,
                        num_no_calls.astype(_F64) / jnp.maximum(all_reads, 1.0))

    fb = jnp.zeros_like(total_coverage, dtype=jnp.int32)
    fb |= jnp.where(total_coverage < params.low_depth_filter,
                    1 << FILTER_BIT_LOW_DEPTH, 0)
    fb |= jnp.where((q < params.variant_qscore_filter) & (total_coverage != 0),
                    1 << FILTER_BIT_LOW_VARIANT_QSCORE, 0)
    fb |= jnp.where(~sb_ok, 1 << FILTER_BIT_STRAND_BIAS, 0)
    fb |= jnp.where(freq < _F32(params.min_frequency_filter),
                    1 << FILTER_BIT_LOW_VARIANT_FREQUENCY, 0)
    fb |= jnp.where(frac_nc > params.no_call_filter,
                    1 << FILTER_BIT_NO_CALL, 0)

    return {
        "frequency": freq,
        "variant_qscore": q,
        "genotype": gt,
        "gq": gq,
        "sb_score": sb_score,
        "sb_gatk": sb_gatk,
        "sb_acceptable": sb_ok,
        "sb_var_both": var_both,
        "sb_cov_both": cov_both,
        "filter_bits": fb,
        "fraction_no_calls": frac_nc,
    }
