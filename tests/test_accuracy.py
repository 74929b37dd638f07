"""Accuracy arms beyond byte-parity: the germline hap.py-analog
(run_analysis.sh:142+ — diploid het/hom truth, genotype-aware scoring)
and phased-MNV recall/precision (PhasedVariantExtractor.cs:40-233),
plus the statistical low-VF titration claim (n>=100 sites per point,
Wilson CIs)."""
import csv
import os

import conftest  # noqa: F401
from pisces_tpu.apps.accuracy import (
    run_germline, run_mnv_accuracy, score_germline, score_mnvs,
)
from pisces_tpu.apps.titration import TruthSite, wilson_ci


def test_germline_thresholding(tmp_path):
    """Diploid-by-thresholding on planted het (VF .5) / hom (VF 1.0)
    SNV+indel truth: genotype-aware recall and precision >= 0.95 for both
    zygosities (the hap.py germline bar)."""
    res = run_germline(str(tmp_path / "g"), sites_per_zyg=30, depth=120,
                       chrom_len=20_000, seed=11)
    for z in ("het", "hom"):
        r = res[z]
        assert r.recall >= 0.95, (z, vars(r))
        assert r.precision >= 0.95, (z, vars(r))
        assert r.gt_concordance >= 0.95, (z, vars(r))
    csv_text = (tmp_path / "g" / "germline_summary.csv").read_text()
    assert csv_text.startswith("model,zygosity,")
    assert csv_text.count("\n") == 3


def test_germline_adaptive(tmp_path):
    """Same truth through the adaptive-GT model (run_analysis.sh calls
    both arms): the EM mixture must genotype planted het/hom correctly."""
    res = run_germline(str(tmp_path / "ga"), sites_per_zyg=30, depth=120,
                       chrom_len=20_000, adaptive=True, seed=11)
    for z in ("het", "hom"):
        r = res[z]
        assert r.recall >= 0.95, (z, vars(r))
        assert r.gt_concordance >= 0.95, (z, vars(r))


def test_mnv_direct_calling(tmp_path):
    """-CallMNVs mode on planted 2-3-site haplotypes: the combined MNV
    allele (with intervening reference bases) is called PASS."""
    r = run_mnv_accuracy(str(tmp_path / "m"), mode="mnv",
                         n_haplotypes=16, depth=250, seed=13)
    assert r.recall >= 0.9, vars(r)
    assert r.precision >= 0.9, vars(r)


def test_mnv_scylla_phasing(tmp_path):
    """The production 2-stage flow (Pisces SNVs -> Scylla phasing): the
    phased VCF recovers the planted haplotypes as MNVs."""
    r = run_mnv_accuracy(str(tmp_path / "s"), mode="scylla",
                         n_haplotypes=16, depth=250, seed=13)
    assert r.recall >= 0.9, vars(r)
    assert r.precision >= 0.9, vars(r)


def test_score_germline_gt_matching(tmp_path):
    """Genotype-aware matcher: right allele + wrong GT is a gt_err (not a
    TP); 1/2 crushed lines count per-allele as het."""
    truth = [TruthSite("chr1", 100, "A", "C", 0.5),
             TruthSite("chr1", 300, "G", "T", 1.0),
             TruthSite("chr1", 500, "T", "G", 1.0)]
    vcf = tmp_path / "g.vcf"
    fmt = "GT:GQ:AD:DP:VF"
    vcf.write_text(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        f"chr1\t100\t.\tA\tC\t100\tPASS\t.\t{fmt}\t0/1:99:50,50:100:0.5\n"
        # hom truth called het -> gt_err
        f"chr1\t300\t.\tG\tT\t100\tPASS\t.\t{fmt}\t0/1:99:50,50:100:0.5\n"
        # non-truth PASS -> fp (truth at 500 absent -> fn)
        f"chr1\t700\t.\tC\tA\t100\tPASS\t.\t{fmt}\t1/1:99:0,100:100:1.0\n")
    res = score_germline(str(vcf), truth)
    assert res["het"].tp == 1 and res["het"].gt_err == 0
    assert res["hom"].tp == 0 and res["hom"].gt_err == 1
    assert res["hom"].fn == 1
    assert res["het"].fp == 1 and res["hom"].fp == 1


def test_score_mnvs_shapes():
    """Only MNV-shaped non-truth calls count as FP; SNV leftovers don't."""
    truth = [TruthSite("c", 10, "ACG", "TCA", 0.25)]
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".vcf",
                                     delete=False) as f:
        fmt = "GT:VF"
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                "\tS\n"
                f"c\t10\t.\tACG\tTCA\t100\tPASS\t.\t{fmt}\t0/1:0.25\n"
                f"c\t50\t.\tAG\tTC\t100\tPASS\t.\t{fmt}\t0/1:0.25\n"
                f"c\t70\t.\tA\tT\t100\tPASS\t.\t{fmt}\t0/1:0.25\n")
        path = f.name
    r = score_mnvs(path, truth)
    os.unlink(path)
    assert r.tp == 1 and r.fp == 1 and r.fn == 0


def test_wilson_ci():
    lo, hi = wilson_ci(90, 100)
    assert 0.82 < lo < 0.87 and 0.93 < hi < 0.96
    assert wilson_ci(0, 0) == (0.0, 1.0)
    lo, hi = wilson_ci(100, 100)
    assert hi == 1.0 and lo > 0.96


def test_committed_lowvf_csv_is_statistical():
    """The committed low-VF regime claim (docs/titration_lowvf.csv) must
    rest on n>=100 sites per VF point, and the 2%-VF recall>=0.9 claim
    must hold at the CI lower bound."""
    path = os.path.join(os.path.dirname(__file__), "..", "docs",
                        "titration_lowvf.csv")
    rows = list(csv.DictReader(open(path)))
    assert len(rows) >= 3  # 1 / 1.5 / 2 % ladder
    for row in rows:
        assert int(row["n_sites"]) >= 100, row
    by_vf = {float(r["vf"]): r for r in rows}
    assert float(by_vf[0.02]["recall_ci_lo"]) >= 0.9, by_vf[0.02]
    # the 1% point sits at the calling threshold: the measurement must be
    # present with a tight-enough CI to be meaningful (width < 0.2)
    r1 = by_vf[0.01]
    width = float(r1["recall_ci_hi"]) - float(r1["recall_ci_lo"])
    assert width < 0.2, r1
