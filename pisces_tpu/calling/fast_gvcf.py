"""Columnar gVCF reference-line pipeline (the dense hot path).

gVCF output is O(genome length) (SURVEY: RegionState.GetAllCandidates makes
per-base ref synthesis the dominant volume path). Instead of materializing a
Candidate + CalledAllele object per covered position, this path:

  1. scores every touched position with the fused device kernel
     (ops/jax_scoring.score_reference_loci) in one pass,
  2. formats reference VCF lines columnar on the host,
  3. leaves variant positions to the exact object pipeline and splices the
     two streams by position at write time.

Output is byte-identical to the object path (asserted in tests); positions
needing non-columnar semantics (gapped-MNV ref adjustments) fall back to the
object path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from pisces_tpu.domain.types import AlleleType, Genotype
from pisces_tpu.options import PiscesApplicationOptions
from pisces_tpu.pileup.counts import PileupCounts
from pisces_tpu.io.vcf_write import VcfWriterConfig, dotnet_format
from pisces_tpu.utils.metrics import metrics

_GT_STR = {
    int(Genotype.HOMOZYGOUS_REF): "0/0",
    int(Genotype.REF_LIKE_NOCALL): "./.",
    int(Genotype.REF_AND_NOCALL): "0/.",
}

# minimum unique-tuple batch for device dispatch (the same default as
# caller.py device_batch_threshold; not measured on the GPU)
DEVICE_TUPLE_THRESHOLD = 4096


def score_reference_positions(pc: PileupCounts, refseq: np.ndarray,
                              params, use_device: bool = True,
                              intervals=None, diploid_snv_params=None):
    """Score gVCF reference loci columnar.

    Without intervals: every touched position with any count. With an
    interval set: EVERY interval position (clipped to the chromosome),
    whether covered or not — zero-count rows score to the same no-call line
    the reference's RegionMapper pads (RegionMapper.cs:31-85), so interval
    padding and in-block zero-coverage synthesis unify into one columnar
    pass (RegionState.GetAllCandidates interval clipping, cs:393-400).

    Returns (positions[int64], scored) where scored holds UNIQUE-tuple
    outputs plus the per-position inverse index: every scoring output is a
    pure function of the (support_by_dir, coverage_by_dir) 6-tuple, so the
    expensive math runs once per unique tuple (U << L for gVCF reference
    loci) and line formatting memoizes per unique tuple too. The tuples
    come from the native pileup when available (pc.pos_tuples, computed in
    C++ next to the count scatter) so the dense [L,6,3] tensor is never
    re-reduced in Python.
    """
    from pisces_tpu.domain.types import BASE_TO_ALLELE, COVERAGE_CONTRIBUTING_ALLELES

    nb = len(pc.block_keys)
    if intervals is not None:
        ranges = intervals.clipped_ranges(1, len(refseq))
        if not ranges:
            return np.empty(0, np.int64), None
        positions = np.concatenate(
            [np.arange(rs, re_ + 1, dtype=np.int64) for rs, re_ in ranges])
        rows = pc.pos_index(positions) if nb else np.full(len(positions), -1)
        if pc.pos_tuples is not None:
            tup = np.zeros((len(positions), pc.pos_tuples.shape[1]),
                           pc.pos_tuples.dtype)
            hit = rows >= 0
            tup[hit] = pc.pos_tuples[rows[hit]]
            all_support_by_dir = tup[:, :3]
            all_cov_by_dir = tup[:, 3:6]
        else:
            flat = pc.counts_t.reshape(nb * pc.block_size,
                                       *pc.counts_t.shape[2:]) if nb else None
            counts = np.zeros((len(positions),) + tuple(pc.counts_t.shape[2:]),
                              pc.counts_t.dtype)
            hit = rows >= 0
            if flat is not None:
                counts[hit] = flat[rows[hit]]
            ref_codes = BASE_TO_ALLELE[refseq[positions - 1]].astype(np.int32)
            cov_alleles = np.array([int(a) for a in COVERAGE_CONTRIBUTING_ALLELES])
            all_cov_by_dir = counts[:, cov_alleles, :].sum(axis=1)
            all_support_by_dir = counts[np.arange(len(counts)), ref_codes, :]
    elif nb == 0:
        return np.empty(0, np.int64), None
    elif getattr(pc, "gvcf_unique", None) is not None:
        # the C++ pileup already selected covered in-reference loci and
        # deduped them to unique tuples (pileup_gvcf_unique)
        positions, uniq, inv = pc.gvcf_unique
        if len(positions) == 0:
            return positions, None
        return _finish_scoring(positions, uniq, inv, None, refseq, params,
                               use_device, diploid_snv_params)
    else:
        block_size = pc.block_size
        starts = (pc.block_keys - 1) * block_size + 1
        positions = (starts[:, None] + np.arange(block_size)[None, :]).reshape(-1)
        in_ref = positions <= len(refseq)

        if pc.pos_tuples is not None:
            tup = pc.pos_tuples
            total_support = tup[:, 3:7].sum(axis=1)  # cov(3) + N total
            sel = (total_support > 0) & in_ref
            tup = tup[sel]
            all_support_by_dir = tup[:, :3]
            all_cov_by_dir = tup[:, 3:6]
            positions = positions[sel]
            if len(positions) == 0:
                return positions, None
        else:
            counts = pc.counts_t.reshape(nb * block_size,
                                         *pc.counts_t.shape[2:])
            total_support = counts.sum(axis=(1, 2))
            sel = (total_support > 0) & in_ref
            positions = positions[sel]
            counts = counts[sel]
            if len(positions) == 0:
                return positions, None
            ref_codes = BASE_TO_ALLELE[refseq[positions - 1]].astype(np.int32)
            cov_alleles = np.array([int(a) for a in COVERAGE_CONTRIBUTING_ALLELES])
            all_cov_by_dir = counts[:, cov_alleles, :].sum(axis=1)
            all_support_by_dir = counts[np.arange(len(counts)), ref_codes, :]
    if len(positions) == 0:
        return positions, None

    pad_flag = None
    if intervals is not None:
        pad_flag = (rows < 0).astype(np.int64)
    uniq, inv = _unique_tuples(all_support_by_dir, all_cov_by_dir, pad_flag)
    return _finish_scoring(positions, uniq, inv, pad_flag, refseq, params,
                           use_device, diploid_snv_params)


def _finish_scoring(positions, uniq, inv, pad_flag, refseq, params,
                    use_device, diploid_snv_params):
    """Score the unique tuples and assemble the per-position output dict."""
    if diploid_snv_params is not None:
        # diploid-thresholding ref lines: vectorized f64 host twin (the
        # fused device kernel implements somatic GT/GQ only)
        out = _score_host_tuples_diploid(uniq[:, :3], uniq[:, 3:6], params,
                                         diploid_snv_params)
    # below the threshold the f64 host path scores: it is the byte-parity
    # oracle, and a small batch saves little next to a launch and a sync
    elif use_device and len(uniq) >= DEVICE_TUPLE_THRESHOLD:
        import jax
        from pisces_tpu.ops.jax_scoring import score_reference_tuples
        u = len(uniq)
        # pad to a power-of-two tile so XLA compiles one kernel per size class
        upad = max(128, 1 << (u - 1).bit_length())
        sup_p = np.zeros((upad, 3), np.int32)
        cov_p = np.zeros((upad, 3), np.int32)
        sup_p[:u] = uniq[:, :3]
        cov_p[:u] = uniq[:, 3:6]
        out_u = score_reference_tuples(jax.device_put(sup_p),
                                       jax.device_put(cov_p), params)
        keep_keys = ("total_coverage", "support", "variant_qscore",
                     "frequency", "genotype", "gq", "sb_gatk")
        out = {k: np.asarray(out_u[k])[:u] for k in keep_keys}
        metrics.count("device_rows_reference_tuples", u)
    else:
        out = _score_host_tuples(uniq[:, :3], uniq[:, 3:6], params)
    if pad_flag is not None:
        out["is_padding"] = uniq[:, 6].astype(bool)
    out["inv"] = inv
    out["ref_base"] = refseq[positions - 1]
    return positions, out


def _unique_tuples(support_by_dir, cov_by_dir, extra=None):
    """np.unique over the per-locus tuples, packed into one int64 when
    values fit in 10 bits (the common case): a 1-D unique is ~20x faster
    than unique(axis=0)'s void-dtype row sort.

    extra: optional int column (small, e.g. a 0/1 padding flag) appended to
    the dedup key so rows with identical counts but different formatting
    semantics (RegionMapper padding sets NL, in-block zero rows don't) stay
    distinct unique tuples. Returned uniq has 6 (+1) columns.
    """
    cols = [support_by_dir, cov_by_dir]
    if extra is not None:
        cols.append(np.asarray(extra).reshape(-1, 1))
    key = np.concatenate(cols, axis=1)
    k = key.shape[1]
    hi = int(key[:, :6].max(initial=0))
    flag_ok = extra is None or (0 <= int(key[:, 6:].min(initial=0))
                                and int(key[:, 6:].max(initial=0)) < 2)
    if 0 <= int(key[:, :6].min(initial=0)) and hi < (1 << 10) and flag_ok:
        # 6 count fields x 10 bits + optional 1-bit flag = 61 bits
        packed = np.zeros(len(key), dtype=np.int64)
        for j in range(6):
            packed = (packed << 10) | key[:, j].astype(np.int64)
        if extra is not None:
            packed = (packed << 1) | key[:, 6].astype(np.int64)
        u, inv = np.unique(packed, return_inverse=True)
        uniq = np.empty((len(u), k), dtype=np.int64)
        if extra is not None:
            uniq[:, 6] = u & 1
            u = u >> 1
        for j in range(5, -1, -1):
            uniq[:, j] = u & 0x3FF
            u = u >> 10
        return uniq, inv
    return np.unique(key, axis=0, return_inverse=True)


def _score_host_tuples_diploid(support_by_dir, cov_by_dir, params,
                               snv_params):
    """Vectorized diploid-thresholding twin for REFERENCE loci
    (DiploidThresholdingGenotyper.cs:53-138 with no variant alleles +
    DiploidGenotypeQualityCalculator.cs:17-103 HomozygousRef branch).
    Same f64/f32 arithmetic as genotype/diploid.py, so outputs are
    byte-identical to the object path."""
    import math

    import scipy.special as sc

    from pisces_tpu.ops import stats

    total_cov = cov_by_dir.sum(axis=-1)
    support = support_by_dir.sum(axis=-1)
    q = stats.compute_variant_qscores(support, total_cov,
                                      params.max_variant_qscore,
                                      params.noise_level)
    q = np.where((total_cov == 0) | (support <= 0), 0, q)
    freq = np.where(total_cov == 0, 0.0,
                    np.minimum(support.astype(np.float32)
                               / np.maximum(total_cov, 1).astype(np.float32),
                               1.0))
    sb = stats.compute_strand_bias(support_by_dir, cov_by_dir,
                                   params.noise_level, params.min_frequency,
                                   params.sb_acceptance, 1)
    gatk = np.where(support > 0, sb["gatk_bias_score"], 0.0)

    minor_vf = snv_params.minor_vf
    # CalculateDiploidGenotype for a lone reference allele: depth issue ->
    # RefLikeNoCall; !refExists -> RefLikeNoCall; too much non-ref ->
    # RefAndNoCall; else HomozygousRef
    gt = np.full(len(total_cov), int(Genotype.HOMOZYGOUS_REF), np.int64)
    gt = np.where((1.0 - freq) > minor_vf, int(Genotype.REF_AND_NOCALL), gt)
    gt = np.where(freq < minor_vf, int(Genotype.REF_LIKE_NOCALL), gt)
    gt = np.where(total_cov < params.min_depth,
                  int(Genotype.REF_LIKE_NOCALL), gt)

    # GQ: likelihood ratio of hom-ref noise Poisson vs het binomial over
    # the non-allele calls (f32 parameters widened exactly like the C#)
    non_allele = np.maximum(total_cov - support, 0)
    depth = total_cov.astype(np.float64)
    lam = float(np.float32(0.05)) * depth
    with np.errstate(divide="ignore", invalid="ignore"):
        h0 = (non_allele * np.log(np.maximum(lam, 1e-300)) - lam
              - sc.gammaln(non_allele + 1.0))
        h1 = _binom_logpmf_vec(non_allele, total_cov,
                               float(np.float32(0.40)))
        raw = np.floor(10.0 * math.log10(math.e) * (h0 - h1))
    gq = np.clip(np.where(np.isfinite(raw), raw, params.min_gq),
                 params.min_gq, params.max_gq).astype(np.int64)
    gq = np.where((total_cov == 0)
                  | (gt != int(Genotype.HOMOZYGOUS_REF)),
                  params.min_gq, gq)

    return {
        "total_coverage": total_cov,
        "support": support,
        "variant_qscore": q,
        "frequency": freq,
        "genotype": gt,
        "gq": gq,
        "sb_gatk": gatk,
    }


def _binom_logpmf_vec(k, n, p):
    import scipy.stats as sps
    return sps.binom.logpmf(k, n, p)


def _score_host_tuples(support_by_dir, cov_by_dir, params):
    """Host (f64) twin of ops/jax_scoring.score_reference_tuples, for
    bit-parity with the reference math."""
    from pisces_tpu.ops import stats
    total_cov = cov_by_dir.sum(axis=-1)
    support = support_by_dir.sum(axis=-1)
    q = stats.compute_variant_qscores(support, total_cov,
                                      params.max_variant_qscore,
                                      params.noise_level)
    q = np.where((total_cov == 0) | (support <= 0), 0, q)
    freq = np.where(total_cov == 0, 0.0,
                    np.minimum(support.astype(np.float32)
                               / np.maximum(total_cov, 1).astype(np.float32), 1.0))
    sb = stats.compute_strand_bias(support_by_dir, cov_by_dir,
                                   params.noise_level, params.min_frequency,
                                   params.sb_acceptance, 1)
    gatk = np.where(support > 0, sb["gatk_bias_score"], 0.0)
    gt = stats.somatic_genotypes(np.ones(len(total_cov), bool), freq, freq,
                                 total_cov, params.min_frequency_filter,
                                 params.min_depth)
    gq = stats.somatic_genotype_qscores(gt, q, freq, total_cov,
                                        params.target_lod, params.min_gq,
                                        params.max_gq)
    return {
        "total_coverage": total_cov,
        "support": support,
        "variant_qscore": q,
        "frequency": freq,
        "genotype": gt,
        "gq": gq,
        "sb_gatk": gatk,
    }


def format_reference_lines(chrom: str, positions: np.ndarray, out: dict,
                           wcfg: VcfWriterConfig,
                           low_depth_filter: int,
                           qscore_filter: int) -> List[str]:
    """Columnar VCF line formatting for reference loci (uncrushed mode,
    FORMAT GT:GQ:AD:DP:VF[:NL:SB]).

    The QUAL/FILTER/INFO/FORMAT tail of each line is a pure function of the
    unique scoring tuple, so it is rendered once per unique tuple and each line
    is just chrom + pos + ref_base + the memoized tail."""
    n = len(positions)
    if n == 0:
        return []
    total = out["total_coverage"]
    support = out["support"]
    q = out["variant_qscore"]
    gq = out["gq"]
    gt = out["genotype"]
    gatk = np.clip(out["sb_gatk"], -100.0, 0.0)
    inv = out["inv"]
    ref_base = out["ref_base"]
    freq_digits = wcfg.freq_decimals
    include_sb = wcfg.should_output_strand_bias_and_noise_level
    nl = wcfg.estimated_base_call_quality

    # per-unique FILTER
    low_dp = total < low_depth_filter
    low_q = (q < qscore_filter) & (total != 0)
    q_filter_tag = f"q{qscore_filter}"
    filt_lut = ["PASS", q_filter_tag, "LowDP", f"LowDP;{q_filter_tag}"]
    filt_code = (low_dp.astype(np.int8) << 1) | low_q.astype(np.int8)

    # per-unique VF string: 1 - freq (0 when no coverage), f32 semantics
    with np.errstate(invalid="ignore"):
        vf = np.where(total == 0, 0.0,
                      1.0 - np.minimum(
                          support.astype(np.float32)
                          / np.maximum(total, 1).astype(np.float32), 1.0))

    is_pad = out.get("is_padding")

    u = len(total)
    tails = [""] * u
    for i in range(u):
        gt_s = _GT_STR.get(int(gt[i]), "./.")
        vf_s = dotnet_format(float(vf[i]), freq_digits)
        if include_sb:
            sb_s = dotnet_format(float(gatk[i]), 4)
            # zero-support alleles never reach the scoring batch in the
            # object path, so their NoiseLevelApplied stays at default 0 —
            # EXCEPT RegionMapper interval padding, which stamps the
            # configured noise level (RegionMapper.cs empty-call synthesis)
            nl_i = nl if (support[i] > 0
                          or (is_pad is not None and is_pad[i])) else 0
            tails[i] = (f"\t.\t{q[i]}\t{filt_lut[filt_code[i]]}\t"
                        f"DP={total[i]}\tGT:GQ:AD:DP:VF:NL:SB\t"
                        f"{gt_s}:{gq[i]}:{support[i]}:{total[i]}:{vf_s}:"
                        f"{nl_i}:{sb_s}")
        else:
            tails[i] = (f"\t.\t{q[i]}\t{filt_lut[filt_code[i]]}\t"
                        f"DP={total[i]}\tGT:GQ:AD:DP:VF\t"
                        f"{gt_s}:{gq[i]}:{support[i]}:{total[i]}:{vf_s}")

    from pisces_tpu.io.native import render_reference_lines
    rendered = render_reference_lines(chrom + "\t", positions, inv,
                                      ref_base, tails)
    if rendered is not None:
        blob, off, owner = rendered
        return RefLineBlock(blob, off, owner)

    pos_l = positions.tolist()
    inv_l = inv.tolist()
    base_l = ref_base.tobytes().decode("latin-1")
    prefix = chrom + "\t"
    return [f"{prefix}{p}\t.\t{b}{tails[v]}"
            for p, b, v in zip(pos_l, base_l, inv_l)]


class RefLineBlock:
    """Reference VCF lines as one rendered byte blob + [n+1] line offsets
    (C++ render_ref_lines output): bulk runs write as single buffer slices
    instead of n Python string objects. `blob` may be a memoryview into the
    native render buffer — `owner` keeps that buffer alive for the lifetime
    of this block and of every slice() sharing it (zero-copy end to end:
    C++ render buffer → fh.buffer.write)."""

    __slots__ = ("blob", "off", "owner")

    def __init__(self, blob, off: np.ndarray, owner=None):
        self.blob = blob
        self.off = off
        self.owner = owner

    def __len__(self) -> int:
        return len(self.off) - 1

    def line(self, i: int) -> str:
        """Line i without its trailing newline."""
        return bytes(self.blob[self.off[i]:self.off[i + 1] - 1]).decode(
            "latin-1")

    def write_range(self, fh, i: int, j: int) -> None:
        if j <= i:
            return
        raw = getattr(fh, "buffer", None)
        if raw is not None:
            # bypass the TextIOWrapper (its utf-8 encode would copy the
            # whole run); flush first so interleaved text writes stay
            # ordered — and the flush is never elidable in practice, since
            # every ref run in the spliced stream is preceded by variant
            # text. VCF bodies are pure ASCII.
            fh.flush()
            raw.write(self.blob[self.off[i]:self.off[j]])
        else:
            fh.write(bytes(self.blob[self.off[i]:self.off[j]]).decode(
                "latin-1"))

    def slice(self, i: int, j: int) -> "RefLineBlock":
        base = self.off[i]
        return RefLineBlock(self.blob[base:self.off[j]],
                            self.off[i:j + 1] - base, self.owner)
