"""Tracing/metrics subsystem (SURVEY §5: this rebuild's structured
observability: stage timers, step counters, device peak memory)."""
import json
import os


def test_stage_timing_and_counters(tmp_path):
    from pisces_tpu.utils.metrics import Metrics
    m = Metrics()
    with m.stage("a"):
        pass
    with m.stage("a"):
        pass
    m.count("reads", 100)
    m.count("reads", 50)
    snap = m.snapshot()
    assert snap["stages"]["a"]["calls"] == 2
    assert snap["counters"]["reads"] == 150
    assert m.rate("reads") > 0
    p = tmp_path / "m.json"
    m.write_json(str(p))
    assert json.load(open(p))["counters"]["reads"] == 150
    m.reset()
    assert m.snapshot()["stages"] == {}


def test_pipeline_populates_metrics(tmp_path):
    """An end-to-end run records reads + loci counters and stage times."""
    import conftest
    from pisces_tpu.utils.metrics import metrics
    from pisces_tpu.io.fasta import Genome
    from pisces_tpu.options import PiscesApplicationOptions
    from pisces_tpu.apps.pisces import process_bam

    metrics.reset()
    o = PiscesApplicationOptions()
    o.output_directory = str(tmp_path)
    o.vcf_writing_parameters.output_gvcf_file = True
    bam = conftest.shared_bam("PhiX_S3.bam")
    gdir = os.path.join(conftest.shared_genome("PhiX"), "WholeGenomeFasta")
    out = process_bam(o, bam, Genome(gdir), use_device=False)
    snap = metrics.snapshot()
    assert snap["counters"]["reads"] > 0
    assert "bam_fetch" in snap["stages"]
    assert "allele_calling" in snap["stages"]
    assert os.path.exists(out)
