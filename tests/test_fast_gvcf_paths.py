"""Columnar fast-gVCF path vs the per-candidate object path: byte parity
with intervals, forced alleles, and windowed streaming (the cases the fast
path previously bailed on).

The object path (use_fast_gvcf=False) materializes a Candidate per covered
position + RegionMapper padding (RegionState.GetAllCandidates:383-460,
RegionMapper.cs:31-85); the fast path folds all of it into one columnar
scoring + formatting pass. Output must be byte-identical.
"""
import os

import pytest

import conftest
from pisces_tpu.apps.pisces import process_bam
from pisces_tpu.io.fasta import Genome
from pisces_tpu.options import PiscesApplicationOptions

TESTDATA = os.path.join(conftest.REFERENCE_ROOT, "src/test/Pisces.Tests/TestData")
BAM = os.path.join(TESTDATA, "Chr17again.bam")
# intervals straddling uncovered positions (zero-coverage padding), the
# covered pileup, and a region fully outside any touched block
INTERVALS = ("chr19\t3118870\t3118895\n"
             "chr19\t3118940\t3118960\n"
             "chr19\t3000000\t3000019\n")


def _run(tmp_path, sub, fast, intervals_text=None, forced_vcf=None,
         window=0, use_device=False):
    d = tmp_path / sub
    d.mkdir()
    o = PiscesApplicationOptions()
    o.output_directory = str(d)
    o.vcf_writing_parameters.output_gvcf_file = True
    o.use_fast_gvcf = fast
    o.window_size = window
    if intervals_text is not None:
        ipath = os.path.join(str(d), "intervals.picard")
        with open(ipath, "w") as f:
            f.write(intervals_text)
        o.interval_paths = [ipath]
    if forced_vcf is not None:
        o.forced_alleles_paths = [forced_vcf]
    genome = Genome(conftest.shared_genome("chr19"))
    out = process_bam(o, BAM, genome, use_device=use_device)
    return [l for l in open(out) if not l.startswith("##")]


def _forced_vcf(tmp_path):
    """One forced allele at an uncalled position inside coverage (forced-only
    locus -> ref line must survive) and one matching the natural variant."""
    p = str(tmp_path / "forced.vcf")
    with open(p, "w") as f:
        f.write("##fileformat=VCFv4.1\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                "chr19\t3118900\t.\tT\tG\t.\tPASS\t.\n"
                "chr19\t3118942\t.\tA\tT\t.\tPASS\t.\n")
    return p


class TestFastPathParity:
    def test_intervals(self, tmp_path):
        fast = _run(tmp_path, "fast", True, intervals_text=INTERVALS)
        slow = _run(tmp_path, "slow", False, intervals_text=INTERVALS)
        assert fast == slow
        # out-of-pileup interval region got padded
        assert any(l.startswith("chr19\t3000000\t") for l in fast)

    def test_forced_alleles(self, tmp_path):
        fvcf = _forced_vcf(tmp_path)
        fast = _run(tmp_path, "fast", True, forced_vcf=fvcf)
        slow = _run(tmp_path, "slow", False, forced_vcf=fvcf)
        assert fast == slow
        # the forced-only locus keeps BOTH its reference line and the
        # forced (ForcedReport-filtered) alt line
        at_forced = [l for l in fast if l.startswith("chr19\t3118900\t")]
        assert len(at_forced) == 2
        # locus sort by (ref, alt): forced T>G precedes the T reference line
        assert "\tT\tG\t" in at_forced[0]
        assert "ForcedReport" in at_forced[0]
        assert "\tT\t.\t" in at_forced[1]

    def test_intervals_and_forced(self, tmp_path):
        fvcf = _forced_vcf(tmp_path)
        fast = _run(tmp_path, "fast", True, intervals_text=INTERVALS,
                    forced_vcf=fvcf)
        slow = _run(tmp_path, "slow", False, intervals_text=INTERVALS,
                    forced_vcf=fvcf)
        assert fast == slow

    def test_windowed_with_intervals(self, tmp_path):
        whole = _run(tmp_path, "whole", True, intervals_text=INTERVALS)
        windowed = _run(tmp_path, "win", True, intervals_text=INTERVALS,
                        window=100_000)
        assert whole == windowed

    def test_device_path_with_intervals(self, tmp_path, monkeypatch):
        # force the device branch regardless of batch size (production
        # gates on DEVICE_TUPLE_THRESHOLD; this corpus is far below it)
        from pisces_tpu.calling import fast_gvcf
        monkeypatch.setattr(fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
        host = _run(tmp_path, "host", True, intervals_text=INTERVALS,
                    use_device=False)
        dev = _run(tmp_path, "dev", True, intervals_text=INTERVALS,
                   use_device=True)
        assert host == dev


def test_fast_gvcf_eligibility_rules():
    """Fast-path dispatch: somatic and diploid-thresholding qualify (the
    diploid ref math runs through the vectorized host twin); adaptive
    ploidy and a LowGQ filter threshold fall back to the object path."""
    from pisces_tpu.apps.pisces import _fast_gvcf_eligible
    from pisces_tpu.domain.types import PloidyModel

    o = PiscesApplicationOptions()
    o.vcf_writing_parameters.output_gvcf_file = True
    o.validate()
    assert _fast_gvcf_eligible(o, None)
    o.variant_calling_parameters.ploidy_model = \
        PloidyModel.DIPLOID_BY_THRESHOLDING
    o.validate()
    assert _fast_gvcf_eligible(o, None)
    o.variant_calling_parameters.low_genotype_quality_filter = 20
    assert not _fast_gvcf_eligible(o, None)
    o.variant_calling_parameters.low_genotype_quality_filter = None
    o.variant_calling_parameters.ploidy_model = \
        PloidyModel.DIPLOID_BY_ADAPTIVE_GT
    assert not _fast_gvcf_eligible(o, None)


class TestDiploidFastPath:
    """Diploid-thresholding gVCF reference lines through the columnar fast
    path (vectorized DiploidThresholdingGenotyper ref rules + hom-ref GQ
    likelihood ratio) must be byte-identical to the object path."""

    def _run(self, tmp_path, sub, fast: bool, intervals_text=None):
        from pisces_tpu.domain.types import PloidyModel
        d = tmp_path / sub
        d.mkdir()
        o = PiscesApplicationOptions()
        o.output_directory = str(d)
        o.vcf_writing_parameters.output_gvcf_file = True
        o.variant_calling_parameters.ploidy_model = \
            PloidyModel.DIPLOID_BY_THRESHOLDING
        o.use_fast_gvcf = fast
        if intervals_text:
            ipath = os.path.join(str(d), "i.picard")
            with open(ipath, "w") as f:
                f.write(intervals_text)
            o.interval_paths = [ipath]
        genome = Genome(conftest.shared_genome("chr19"))
        out = process_bam(o, BAM, genome, use_device=False)
        return [l for l in open(out) if not l.startswith("##")]

    def test_fast_equals_object(self, tmp_path):
        fast = self._run(tmp_path, "fast", True)
        slow = self._run(tmp_path, "slow", False)
        assert fast == slow
        gts = {l.split("\t")[9].split(":")[0] for l in fast
               if not l.startswith("#") and l.split("\t")[4] == "."}
        assert "0/0" in gts

    def test_fast_equals_object_with_intervals(self, tmp_path):
        iv = INTERVALS
        fast = self._run(tmp_path, "fasti", True, intervals_text=iv)
        slow = self._run(tmp_path, "slowi", False, intervals_text=iv)
        assert fast == slow
        # the zero-coverage interval padding exercises the no-call GT
        gts = {l.split("\t")[9].split(":")[0] for l in fast
               if not l.startswith("#") and l.split("\t")[4] == "."}
        assert "./." in gts and "0/0" in gts

    def test_fast_equals_object_with_subthreshold_variants(self, tmp_path):
        """A locus where a sub-MinorVF variant coexists with the reference
        emits NOTHING in diploid mode (genotyping prunes the variant, the
        variant's presence suppresses the ref line): the fast path must
        reproduce that locus-level pruning (caller.ref_suppressed_positions
        feeds the splice)."""
        import hashlib
        import bench
        from pisces_tpu.domain.types import PloidyModel

        bam, gdir = bench._write_synthetic_workload(
            str(tmp_path / "wl"), n_chroms=1, chrom_len=120_000,
            n_reads=10_000, variant_rate=0.01)
        genome = Genome(gdir)
        lines = {}
        for fast in (False, True):
            o = PiscesApplicationOptions()
            o.output_directory = str(tmp_path / f"d{fast}")
            os.makedirs(o.output_directory, exist_ok=True)
            o.vcf_writing_parameters.output_gvcf_file = True
            o.variant_calling_parameters.ploidy_model = \
                PloidyModel.DIPLOID_BY_THRESHOLDING
            o.use_fast_gvcf = fast
            out = process_bam(o, bam, genome, use_device=False)
            lines[fast] = [l for l in open(out) if not l.startswith("##")]
        assert lines[True] == lines[False]

    def test_chrm_dispatches_somatic_under_diploid(self, tmp_path):
        """chrM is ALWAYS somatic (GenotypeCreator.GetPloidyForThisChr):
        under diploid sample ploidy the chrM fast path must use the somatic
        kernel and match the object path byte-for-byte."""
        import numpy as np
        from pisces_tpu.domain.types import PloidyModel
        from pisces_tpu.io.bam_write import BamWriter
        from pisces_tpu.io.fasta import create_genome_size_xml

        rng = np.random.default_rng(5)
        gdir = tmp_path / "genome"
        gdir.mkdir()
        seq = "".join(rng.choice(list("ACGT"), 2000))
        with open(gdir / "chrM.fa", "w") as f:
            f.write(">chrM\n" + seq + "\n")
        create_genome_size_xml(str(gdir))
        bam = str(tmp_path / "m.bam")
        w = BamWriter(bam, ["chrM"], [len(seq)])
        for i in range(300):
            p = 1 + int(rng.integers(0, 1900))
            w.add_read(f"m{i}", "chrM", p, "60M", seq[p - 1:p + 59],
                       flag=0x10 if i & 1 else 0)
        w.write()
        genome = Genome(str(gdir))
        lines = {}
        for fast in (False, True):
            o = PiscesApplicationOptions()
            o.output_directory = str(tmp_path / f"m{fast}")
            os.makedirs(o.output_directory, exist_ok=True)
            o.vcf_writing_parameters.output_gvcf_file = True
            o.variant_calling_parameters.ploidy_model = \
                PloidyModel.DIPLOID_BY_THRESHOLDING
            o.use_fast_gvcf = fast
            out = process_bam(o, bam, genome, use_device=False)
            lines[fast] = [l for l in open(out) if not l.startswith("##")]
        assert lines[True] == lines[False]
