"""Parity of the device scoring kernels against the f64 host backend.

`check_kernels` scores one seeded grid of (support, coverage)-by-direction
tuples through both device kernels (ops/jax_scoring.score_snv_loci and
score_reference_tuples) and through ops/stats.py, and counts every
disagreement. The contract: integer outputs (q-score, GQ, genotype, filter
bits) and the strand-bias booleans are equal, and the float32 frequency is
within one unit in the last place. The CPU tests run it at small widths;
chip_smoke.py runs it at 2^20 rows on the GPU.
"""
from __future__ import annotations

import numpy as np

from pisces_tpu.domain.types import StrandBiasModel
from pisces_tpu.ops import stats
from pisces_tpu.ops.scoring_params import (
    FILTER_BIT_LOW_DEPTH, FILTER_BIT_LOW_VARIANT_FREQUENCY,
    FILTER_BIT_LOW_VARIANT_QSCORE, FILTER_BIT_NO_CALL, FILTER_BIT_STRAND_BIAS,
    ScoringParams,
)

INT_KEYS = ("variant_qscore", "gq", "genotype", "filter_bits")
SB_KEYS = ("sb_acceptable", "sb_var_both", "sb_cov_both")


def random_tuples(rng, n: int, max_dir_cov: int):
    """[n, 3] support and coverage by direction (forward, reverse,
    stitched), each direction's coverage uniform on [0, max_dir_cov].
    Support mixes the regimes a deep panel produces: a quarter reference-
    like (0.3% non-reference calls), a quarter low-VF variants (0.1-8%),
    half uniform VF; a quarter of the rows carry no stitched reads."""
    cov = rng.integers(0, max_dir_cov + 1, (n, 3))
    cov[rng.random(n) < 0.25, 2] = 0
    regime = rng.integers(0, 4, n)
    vf = rng.random((n, 3))
    low_vf = rng.uniform(0.001, 0.08, (n, 1))
    sup = np.where(regime[:, None] == 0, cov - rng.binomial(cov, 0.003),
                   np.where(regime[:, None] == 1, rng.binomial(cov, low_vf),
                            (cov * vf).astype(np.int64)))
    return sup.astype(np.int64), cov.astype(np.int64)


def _frequency(support, total):
    return np.where(total == 0, np.float32(0.0),
                    np.minimum(support.astype(np.float32)
                               / np.maximum(total, 1).astype(np.float32),
                               np.float32(1.0)))


def _qscores(support, total, params):
    q = stats.compute_variant_qscores(support, total,
                                      params.max_variant_qscore,
                                      params.noise_level)
    return np.where((total == 0) | (support <= 0), 0, q)


def _base_filter_bits(q, total, params):
    return (np.where(total < params.low_depth_filter,
                     1 << FILTER_BIT_LOW_DEPTH, 0)
            | np.where((q < params.variant_qscore_filter) & (total != 0),
                       1 << FILTER_BIT_LOW_VARIANT_QSCORE, 0))


def host_reference_tuples(sup, cov, params: ScoringParams) -> dict:
    """Host twin of score_reference_tuples' outputs, from ops/stats.py."""
    total = cov.sum(axis=1)
    support = sup.sum(axis=1)
    q = _qscores(support, total, params)
    freq = _frequency(support, total)
    gt = stats.somatic_genotypes(np.ones(len(total), bool), freq, freq, total,
                                 params.min_frequency_filter, params.min_depth)
    gq = stats.somatic_genotype_qscores(gt, q, freq, total, params.target_lod,
                                        params.min_gq, params.max_gq)
    return {"variant_qscore": q, "gq": gq, "genotype": gt,
            "filter_bits": _base_filter_bits(q, total, params),
            "frequency": freq}


def host_snv(sup, cov, ref_support, num_no_calls,
             params: ScoringParams) -> dict:
    """Host twin of score_snv_loci's outputs, from ops/stats.py."""
    total = cov.sum(axis=1)
    support = sup.sum(axis=1)
    q = _qscores(support, total, params)
    freq = _frequency(support, total)
    sb = stats.compute_strand_bias(sup, cov, params.noise_level,
                                   params.min_frequency, params.sb_acceptance,
                                   int(StrandBiasModel.EXTENDED))
    gt = stats.somatic_genotypes(np.zeros(len(total), bool), freq,
                                 _frequency(ref_support, total), total,
                                 params.min_frequency_filter, params.min_depth)
    gq = stats.somatic_genotype_qscores(gt, q, freq, total, params.target_lod,
                                        params.min_gq, params.max_gq)
    all_reads = (total + num_no_calls).astype(np.float64)
    frac_nc = np.where(all_reads == 0, 0.0,
                       num_no_calls / np.maximum(all_reads, 1.0))
    bits = (_base_filter_bits(q, total, params)
            | np.where(~sb["bias_acceptable"], 1 << FILTER_BIT_STRAND_BIAS, 0)
            | np.where(freq < np.float32(params.min_frequency_filter),
                       1 << FILTER_BIT_LOW_VARIANT_FREQUENCY, 0)
            | np.where(frac_nc > params.no_call_filter,
                       1 << FILTER_BIT_NO_CALL, 0))
    return {"variant_qscore": q, "gq": gq, "genotype": gt,
            "filter_bits": bits, "frequency": freq,
            "sb_acceptable": sb["bias_acceptable"],
            "sb_var_both": sb["var_present_on_both_strands"],
            "sb_cov_both": sb["cov_present_on_both_strands"]}


def make_grid(n: int, seed: int, max_dir_cov: int) -> dict:
    """The seeded int32 kernel inputs of one parity run."""
    rng = np.random.default_rng(seed)
    sup, cov = random_tuples(rng, n, max_dir_cov)
    total = cov.sum(axis=1)
    ref = np.maximum(total - sup.sum(axis=1) - rng.integers(0, 5, n), 0)
    nc = rng.integers(0, 20, n)
    return {k: v.astype(np.int32) for k, v in
            (("sup", sup), ("cov", cov), ("ref", ref), ("nc", nc),
             ("total", total))}


def run_kernels(grid: dict, params: ScoringParams) -> dict:
    """Both device kernels on one grid; numpy outputs keyed by kernel."""
    from pisces_tpu.ops.jax_scoring import (
        score_reference_tuples, score_snv_loci,
    )
    snv = score_snv_loci(grid["sup"], grid["cov"], grid["ref"], grid["nc"],
                         grid["total"], params)
    ref = score_reference_tuples(grid["sup"], grid["cov"], params)
    return {"score_snv_loci": {k: np.asarray(v) for k, v in snv.items()},
            "score_reference_tuples": {k: np.asarray(v)
                                       for k, v in ref.items()}}


def _compare(dev: dict, host: dict, keys, sup, cov) -> dict:
    out = {}
    for k in keys:
        bad = np.flatnonzero(np.asarray(dev[k]) != np.asarray(host[k]))
        out[k] = {"mismatches": int(bad.size),
                  "examples": [{"sup": sup[i].tolist(), "cov": cov[i].tolist(),
                                "device": np.asarray(dev[k])[i].item(),
                                "host": np.asarray(host[k])[i].item()}
                               for i in bad[:5]]}
    f_dev = np.asarray(dev["frequency"], np.float32).view(np.int32)
    f_host = np.asarray(host["frequency"], np.float32).view(np.int32)
    out["frequency_max_ulp"] = int(np.abs(f_dev.astype(np.int64)
                                          - f_host).max(initial=0))
    return out


def check_kernels(n: int, seed: int = 0, max_dir_cov: int = 5000,
                  params: ScoringParams = ScoringParams(),
                  outputs: dict = None) -> dict:
    """Score a seeded grid on the default JAX device and on the host; return
    per-kernel disagreement counts (see `passed`). `outputs` may hold the
    device outputs of `run_kernels` on the same grid, already computed."""
    grid = make_grid(n, seed, max_dir_cov)
    sup, cov = grid["sup"].astype(np.int64), grid["cov"].astype(np.int64)
    dev = outputs if outputs is not None else run_kernels(grid, params)
    return {
        "rows": n,
        "score_snv_loci": _compare(
            dev["score_snv_loci"],
            host_snv(sup, cov, grid["ref"].astype(np.int64),
                     grid["nc"].astype(np.int64), params),
            INT_KEYS + SB_KEYS, sup, cov),
        "score_reference_tuples": _compare(
            dev["score_reference_tuples"],
            host_reference_tuples(sup, cov, params), INT_KEYS, sup, cov),
    }


def passed(report: dict) -> bool:
    """Exact integers and SB booleans, frequency within 1 ulp."""
    for kernel in ("score_snv_loci", "score_reference_tuples"):
        r = report[kernel]
        if r["frequency_max_ulp"] > 1:
            return False
        if any(v["mismatches"] for k, v in r.items() if isinstance(v, dict)):
            return False
    return True
