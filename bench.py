"""Benchmark: candidate loci scored/sec on one GPU, plus informational
end-to-end stages.

Primary: steady-state throughput of the fused reference-tuple scoring
kernel (ops/jax_scoring.score_reference_tuples: coverage totals + Poisson
q-score + strand bias + somatic GT/GQ + filter bits) over a 2^20-row batch
on the first JAX device, next to the single-core host (numpy f64)
implementation of the same math — the in-repo baseline proxy, since the
reference publishes no throughput numbers (BASELINE.md). The scoring step
is chained K times inside one jit (lax.fori_loop with an
accumulator->input data dependency so XLA cannot hoist the loop body) and
ONE scalar is fetched at the end.

The metric and every informational stage run in a subprocess of their own,
one at a time, so only one process holds the device; this parent process
never initializes JAX. Without a GPU the metric stage fails and so does
main(): no host number is reported under the device metric's name.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline",
"device": {"platform", "device_kind", "count"}, ...}. stderr carries the
informational stage lines.
"""
import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

import numpy as np

CHAIN_ITERS = 64
SHARED_BAMS = "/root/reference/src/test/SharedData/Bams"
SHARED_GENOMES = "/root/reference/src/test/SharedData/Genomes"


def _device_info() -> dict:
    """platform, device_kind and count of JAX's devices (initializes JAX:
    call only in a stage child)."""
    import jax
    from pisces_tpu.utils.device import configure_compile_cache
    configure_compile_cache()
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": jax.device_count()}


def bench_device_chained(sup, cov, iters=CHAIN_ITERS):
    """Steady-state rate of the fused tuple-scoring kernel (the production
    reference-locus kernel, ops/jax_scoring.score_reference_tuples), with
    the K-step chain fully on-device and a single host sync."""
    import jax
    import jax.numpy as jnp
    from pisces_tpu.ops.jax_scoring import ScoringParams, score_reference_tuples

    params = ScoringParams()
    L = sup.shape[0]

    @jax.jit
    def run(s, c):
        def body(i, acc):
            # acc feeds the next iteration's input: no loop hoisting
            out = score_reference_tuples(s + (acc & 1), c + (acc & 1), params)
            return (out["variant_qscore"].sum() + out["gq"].sum()
                    + out["filter_bits"].sum())
        return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

    s_d = jax.device_put(sup)
    c_d = jax.device_put(cov)
    with jax.enable_x64(True):  # the kernel computes in float64
        v = int(run(s_d, c_d))  # compile + warm
        t0 = time.perf_counter()
        v = int(run(s_d, c_d))
        dt = time.perf_counter() - t0
    assert v != 0
    return L * iters / dt


def bench_host(counts, ref_code, iters=1):
    """Same scoring contract in the f64 numpy parity backend."""
    from pisces_tpu.ops import stats

    cov_alleles = np.array([0, 1, 2, 3, 5])
    t0 = time.perf_counter()
    for _ in range(iters):
        c = counts.sum(axis=-1)
        cov_by_dir = c[:, cov_alleles, :].sum(axis=1)
        total_cov = cov_by_dir.sum(axis=-1)
        sup_by_dir = c[np.arange(len(c)), ref_code, :]
        support = sup_by_dir.sum(axis=-1)
        q = stats.compute_variant_qscores(support, total_cov, 100, 20)
        stats.compute_strand_bias(sup_by_dir, cov_by_dir, 20, 0.01, 0.5, 1)
        freq = np.where(total_cov == 0, 0.0, support / np.maximum(total_cov, 1))
        gt = stats.somatic_genotypes(np.ones(len(c), bool),
                                     freq.astype(np.float32),
                                     freq.astype(np.float32), total_cov, 0.01, 10)
        stats.somatic_genotype_qscores(gt, q, freq.astype(np.float32),
                                       total_cov, 0.01, 0, 100)
    dt = time.perf_counter() - t0
    return counts.shape[0] * iters / dt


def _write_synthetic_workload(tmp: str, n_chroms: int, chrom_len: int,
                              n_reads: int, read_len: int = 100,
                              variant_rate: float = 0.01,
                              seed: int = 0, messy: bool = True):
    """Synthetic multi-chromosome BAM + genome with planted SNVs so both
    the dense gVCF path and the candidate-scoring path do real work.

    messy=True (the default, and what every committed stage measures)
    additionally makes the read profile reference-realistic instead of
    uniformly clean 100M/Q30: ~1% of reads carry a 2bp CIGAR insertion or
    deletion, ~10% are 8bp-softclipped at one end, and ~20% have a
    low-quality (Q12) 15bp tail. These exercise the indel/softclip
    branches of the CIGAR walk and the quality-filter path at scale
    (reference hot profile: CandidateVariantFinder.cs:90-168,
    AlleleCountHelper.cs:22-80, CoverageCalculator.cs:162-331)."""
    import shutil

    from pisces_tpu.io.bam_write import BamRecord, BamWriter, parse_cigar_string

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "genome"))
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    chroms = [f"chr{i + 1}" for i in range(n_chroms)]
    seqs = {}
    gs = []
    for c in chroms:
        seq = bases[rng.integers(0, 4, chrom_len)]
        seqs[c] = seq
        with open(os.path.join(tmp, "genome", f"{c}.fa"), "wb") as f:
            f.write(f">{c}\n".encode())
            for i in range(0, chrom_len, 70):
                f.write(seq[i:i + 70].tobytes() + b"\n")
        with open(os.path.join(tmp, "genome", f"{c}.fa.fai"), "w") as f:
            f.write(f"{c}\t{chrom_len}\t{len(c) + 2}\t70\t71\n")
        gs.append(f'\t<chromosome fileName="{c}.fa" contigName="{c}" '
                  f'totalBases="{chrom_len}" isCircular="false" md5="x" '
                  f'ploidy="2" knownBases="{chrom_len}" />')
    with open(os.path.join(tmp, "genome", "GenomeSize.xml"), "w") as f:
        f.write('<sequenceSizes genomeName="b">\n' + "\n".join(gs)
                + "\n</sequenceSizes>")

    # prebuilt cigar variants (parse once, reuse per read)
    cig_clean = parse_cigar_string(f"{read_len}M")
    half = read_len // 2
    cig_ins = parse_cigar_string(f"{half - 2}M2I{read_len - half}M")
    cig_del = parse_cigar_string(f"{half - 1}M2D{read_len - half + 1}M")
    cig_sc_l = parse_cigar_string(f"8S{read_len - 8}M")
    cig_sc_r = parse_cigar_string(f"{read_len - 8}M8S")
    q30 = [30] * read_len
    q_dip = [30] * (read_len - 15) + [12] * 15

    w = BamWriter(os.path.join(tmp, "b.bam"), chroms, [chrom_len] * n_chroms)
    per_chrom = n_reads // n_chroms
    var_sites = {c: rng.integers(1, chrom_len - read_len,
                                 max(8, int(chrom_len * variant_rate / 10)))
                 for c in chroms}
    for ci, c in enumerate(chroms):
        seq = seqs[c]
        positions = np.sort(rng.integers(1, chrom_len - read_len - 4,
                                         per_chrom))
        sites = np.sort(var_sites[c])
        cls = rng.random(per_chrom) if messy else np.ones(per_chrom)
        dip = rng.random(per_chrom) < 0.2 if messy else np.zeros(per_chrom,
                                                                 bool)
        for i in range(per_chrom):
            p = int(positions[i])
            cigar = cig_clean
            r = cls[i]
            if r < 0.005:        # 2bp insertion mid-read
                rseq = bytearray(seq[p - 1:p - 1 + half - 2].tobytes())
                rseq += bytes(bases[rng.integers(0, 4, 2)])
                rseq += seq[p - 1 + half - 2:p - 1 + read_len - 2].tobytes()
                cigar = cig_ins
            elif r < 0.01:       # 2bp deletion mid-read
                rseq = bytearray(seq[p - 1:p - 1 + half - 1].tobytes())
                rseq += seq[p + half:p + read_len + 1].tobytes()
                cigar = cig_del
            elif r < 0.06:       # leading 8bp softclip (random bases)
                rseq = bytearray(bytes(bases[rng.integers(0, 4, 8)]))
                rseq += seq[p - 1:p - 1 + read_len - 8].tobytes()
                cigar = cig_sc_l
            elif r < 0.11:       # trailing 8bp softclip
                rseq = bytearray(seq[p - 1:p - 1 + read_len - 8].tobytes())
                rseq += bytes(bases[rng.integers(0, 4, 8)])
                cigar = cig_sc_r
            else:
                rseq = bytearray(seq[p - 1:p - 1 + read_len].tobytes())
                # plant a SNV on ~40% of clean reads covering a variant site
                j = np.searchsorted(sites, p)
                if j < len(sites) and sites[j] < p + read_len and i % 5 < 2:
                    off = int(sites[j]) - p
                    rseq[off] = b"ACGT"[(seq[sites[j] - 1] + 1) % 4]
            w.records.append(BamRecord(
                f"r{ci}_{i}", ci, p - 1, 60, 0x10 if i & 1 else 0,
                cigar, rseq.decode(), q_dip if dip[i] else q30))
    w.write()
    return os.path.join(tmp, "b.bam"), os.path.join(tmp, "genome")


def generate_wgs_workload(tmp: str, n_reads: int = 10_000_000,
                          chrom_len: int = 33_000_000, read_len: int = 100,
                          base_error_rate: float = 0.001,
                          n_var_sites: int = 3000, seed: int = 0,
                          messy: bool = True, vf_range=None,
                          n_indel_sites: int = 0):
    """WGS-scale single-chromosome workload (~30x depth), generated fully
    vectorized: records are assembled as structured-dtype arrays (one per
    CIGAR shape class), BGZF-compressed by the native thread pool, and the
    .bai is built from vectorized bins/voffsets. A per-record Python
    encode loop would take minutes at 10M reads.

    messy=True gives the reads a reference-realistic profile instead of
    uniformly clean 100M/Q30: ~1% carry a 2bp
    CIGAR insertion/deletion, ~10% are 8bp-softclipped at one end, and
    ~20% have a Q12 15bp tail — exercising the indel/softclip branches of
    the CIGAR walk and quality filtering at scale (reference profile:
    CandidateVariantFinder.cs:90-168, CoverageCalculator.cs:162-331).
    Records of different CIGAR lengths have different byte sizes, so the
    classes are assembled separately and merged byte-wise in position
    order.

    Planted variants: n_var_sites SNV sites carried by clean reads at 30%
    VF, or at a VF drawn per site from vf_range=(lo, hi) when given; and
    n_indel_sites recurrent 2 bp insertions (even sites) and deletions (odd
    sites) at the same VFs, written as per-read CIGARs anchored at the
    site."""
    import shutil

    from pisces_tpu.io.bai import (
        LINEAR_SHIFT, BamIndex, RefIndex, write_bai,
    )
    from pisces_tpu.io.bam_write import BamWriter
    from pisces_tpu.io.native import bgzf_compress_parallel

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    gdir = os.path.join(tmp, "genome")
    os.makedirs(gdir)
    chrom = "chrW"
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bases[rng.integers(0, 4, chrom_len)]
    # FASTA in 70-col lines, vectorized
    pad = (-chrom_len) % 70
    grid = np.concatenate([seq, np.zeros(pad, np.uint8)]).reshape(-1, 70)
    lines = np.concatenate(
        [grid, np.full((grid.shape[0], 1), ord("\n"), np.uint8)], axis=1)
    body = lines.tobytes()[:chrom_len + chrom_len // 70
                           + (1 if chrom_len % 70 else 0)]
    with open(os.path.join(gdir, f"{chrom}.fa"), "wb") as f:
        f.write(f">{chrom}\n".encode())
        f.write(body if body.endswith(b"\n") else body + b"\n")
    with open(os.path.join(gdir, f"{chrom}.fa.fai"), "w") as f:
        f.write(f"{chrom}\t{chrom_len}\t{len(chrom) + 2}\t70\t71\n")
    with open(os.path.join(gdir, "GenomeSize.xml"), "w") as f:
        f.write('<sequenceSizes genomeName="wgs">\n'
                f'\t<chromosome fileName="{chrom}.fa" contigName="{chrom}" '
                f'totalBases="{chrom_len}" isCircular="false" md5="x" '
                f'ploidy="2" knownBases="{chrom_len}" />\n</sequenceSizes>')

    pos0 = np.sort(rng.integers(0, chrom_len - read_len - 3, n_reads)
                   ).astype(np.int64)
    # CIGAR-shape class per read: 0=clean 100M, 1=8S92M, 2=92M8S,
    # 3=48M2I50M, 4=49M2D51M (messy=False -> all clean)
    if messy:
        u = rng.random(n_reads)
        cls = np.select([u < 0.89, u < 0.94, u < 0.99, u < 0.995],
                        [0, 1, 2, 3], default=4).astype(np.int8)
    else:
        cls = np.zeros(n_reads, np.int8)
    half = read_len // 2
    # per-class: cigar ops, reference span
    cig_ops = [np.array([(read_len << 4) | 0], np.uint32),
               np.array([(8 << 4) | 4, ((read_len - 8) << 4) | 0],
                        np.uint32),
               np.array([((read_len - 8) << 4) | 0, (8 << 4) | 4],
                        np.uint32),
               np.array([((half - 2) << 4) | 0, (2 << 4) | 1,
                         ((read_len - half) << 4) | 0], np.uint32),
               np.array([((half - 1) << 4) | 0, (2 << 4) | 2,
                         ((read_len - half + 1) << 4) | 0], np.uint32)]
    spans = np.array([read_len, read_len - 8, read_len - 8,
                      read_len - 2, read_len + 2], np.int64)

    def site_vf(n):
        if vf_range is None:
            return np.full(n, 0.3)
        return rng.uniform(vf_range[0], vf_range[1], n)

    # planted recurrent indels: clean reads covering a site (anchored >= 10
    # bases on both sides) become 3-op insertion/deletion reads whose split
    # point is the site; their CIGARs are per read
    cigar3 = np.zeros((n_reads, 3), np.uint32)
    cigar3[cls == 3] = cig_ops[3]
    cigar3[cls == 4] = cig_ops[4]
    indel_reads = []  # (read indices, split k, is_insertion, inserted bases)
    if n_indel_sites:
        grid_sites = np.arange(2 * read_len, chrom_len - 2 * read_len,
                               2 * read_len)
        isites = np.sort(rng.choice(grid_sites, size=n_indel_sites,
                                    replace=False))
        for j, (s0, vf) in enumerate(zip(isites.tolist(),
                                         site_vf(n_indel_sites).tolist())):
            lo = int(np.searchsorted(pos0, s0 - (read_len - 12)))
            hi = int(np.searchsorted(pos0, s0 - 10, side="right"))
            cover = np.arange(lo, hi)
            cover = cover[cls[cover] == 0]
            carriers = cover[rng.random(cover.size) < vf]
            if carriers.size == 0:
                continue
            is_ins = j % 2 == 0
            k = (s0 - pos0[carriers]).astype(np.int64)  # bases before site
            m1 = (k + 1).astype(np.uint32)
            if is_ins:
                cls[carriers] = 3
                cigar3[carriers, 0] = (m1 << 4) | 0
                cigar3[carriers, 1] = (2 << 4) | 1
                cigar3[carriers, 2] = ((read_len - 3 - k).astype(np.uint32)
                                       << 4) | 0
            else:
                cls[carriers] = 4
                cigar3[carriers, 0] = (m1 << 4) | 0
                cigar3[carriers, 1] = (2 << 4) | 2
                cigar3[carriers, 2] = ((read_len - 1 - k).astype(np.uint32)
                                       << 4) | 0
            indel_reads.append((carriers, k, is_ins,
                                bases[rng.integers(0, 4, 2)]))
    end0 = pos0 + spans[cls]

    # read sequences: class-specific vectorized gathers
    reads = np.empty((n_reads, read_len), np.uint8)
    ar = np.arange(read_len)
    m0 = cls == 0
    reads[m0] = seq[pos0[m0, None] + ar[None, :]]
    if messy:
        m1 = cls == 1  # 8S92M: 8 random then ref
        reads[m1, :8] = bases[rng.integers(0, 4, (int(m1.sum()), 8))]
        reads[np.flatnonzero(m1)[:, None], ar[None, 8:]] = \
            seq[pos0[m1, None] + ar[None, :read_len - 8]]
        m2 = cls == 2  # 92M8S
        reads[np.flatnonzero(m2)[:, None], ar[None, :read_len - 8]] = \
            seq[pos0[m2, None] + ar[None, :read_len - 8]]
        reads[m2, read_len - 8:] = bases[
            rng.integers(0, 4, (int(m2.sum()), 8))]
        m3 = cls == 3  # 48M 2I 50M
        i3 = np.flatnonzero(m3)
        reads[i3[:, None], ar[None, :half - 2]] = \
            seq[pos0[m3, None] + ar[None, :half - 2]]
        reads[m3, half - 2:half] = bases[rng.integers(0, 4,
                                                      (i3.size, 2))]
        reads[i3[:, None], ar[None, half:]] = \
            seq[pos0[m3, None] + (half - 2) + ar[None, :read_len - half]]
        m4 = cls == 4  # 49M 2D 51M
        i4 = np.flatnonzero(m4)
        reads[i4[:, None], ar[None, :half - 1]] = \
            seq[pos0[m4, None] + ar[None, :half - 1]]
        reads[i4[:, None], ar[None, half - 1:]] = \
            seq[pos0[m4, None] + (half + 1) + ar[None, :read_len - half + 1]]
    # planted indel reads: ref up to the site, then 2 inserted bases or a
    # 2 bp gap in the reference, then ref to the end of the read
    for carriers, k, is_ins, ins_bases in indel_reads:
        for ki in np.unique(k).tolist():
            r = carriers[k == ki]
            p = pos0[r, None]
            reads[r[:, None], ar[None, :ki + 1]] = seq[p + ar[None, :ki + 1]]
            if is_ins:
                reads[r, ki + 1:ki + 3] = ins_bases[None, :]
                rest = ar[None, :read_len - ki - 3]
                reads[r[:, None], ki + 3 + rest] = seq[p + ki + 1 + rest]
            else:
                rest = ar[None, :read_len - ki - 1]
                reads[r[:, None], ki + 1 + rest] = seq[p + ki + 3 + rest]
    # Q30-consistent random error floor (sparse)
    n_err = int(rng.binomial(n_reads * read_len, base_error_rate))
    flat = rng.integers(0, n_reads * read_len, n_err)
    er, ec = flat // read_len, flat % read_len
    reads[er, ec] = bases[(np.searchsorted(bases, reads[er, ec]) + 1) % 4]
    # planted SNV sites at ~30% VF on clean reads (~27% realized overall;
    # the candidate path does real work)
    sites = np.sort(rng.choice(
        np.arange(read_len, chrom_len - read_len, 2 * read_len),
        size=n_var_sites, replace=False))
    for s, vf in zip(sites.tolist(), site_vf(sites.size).tolist()):
        lo = int(np.searchsorted(pos0, s - read_len + 1))
        hi = int(np.searchsorted(pos0, s, side="right"))
        if hi <= lo:
            continue
        cover = np.arange(lo, hi)
        cover = cover[cls[cover] == 0]
        carriers = cover[rng.random(cover.size) < vf]
        alt = bases[(int(np.searchsorted(bases, seq[s])) + 2) % 4]
        reads[carriers, s - pos0[carriers]] = alt

    # structured-record assembly (layout mirrors BamRecord.encode), one
    # array per cigar-op count; merged byte-wise in position order below
    name_len = 10  # "r%08d" + NUL
    packed = (read_len + 1) // 2
    from pisces_tpu.io.bam_write import _NIBBLE_LUT
    nib = _NIBBLE_LUT[reads]
    seq_packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    del reads, nib
    # quality: base 30 with a 15bp Q12 tail on ~20% of reads
    dip = (rng.random(n_reads) < 0.2) if messy else np.zeros(n_reads, bool)
    names = np.char.mod(b"r%08d", np.arange(n_reads))
    flags = np.where(np.arange(n_reads) & 1, 16, 0).astype(np.uint16)
    # vectorized reg2bin, ALL levels (a read crossing a 128kb boundary
    # must land in the coarser bin or indexed queries can miss it —
    # io/bai.py reg2bin semantics)
    e = end0 - 1
    bins_all = np.select(
        [pos0 >> 14 == e >> 14, pos0 >> 17 == e >> 17,
         pos0 >> 20 == e >> 20, pos0 >> 23 == e >> 23,
         pos0 >> 26 == e >> 26],
        [4681 + (pos0 >> 14), 585 + (pos0 >> 17), 73 + (pos0 >> 20),
         9 + (pos0 >> 23), 1 + (pos0 >> 26)],
        default=0).astype(np.int64)

    def _rec_dtype(n_cigar):
        rec_size = 4 + 32 + name_len + 4 * n_cigar + packed + read_len
        return rec_size, np.dtype({
            "names": ["block_size", "ref_id", "pos", "l_name", "mapq",
                      "bin", "n_cigar", "flag", "l_seq", "next_ref",
                      "next_pos", "tlen", "name", "cigar", "seq", "qual"],
            "formats": ["<i4", "<i4", "<i4", "u1", "u1", "<u2", "<u2",
                        "<u2", "<i4", "<i4", "<i4", "<i4", f"S{name_len}",
                        f"({n_cigar},)<u4", f"({packed},)u1",
                        f"({read_len},)u1"],
            "offsets": [0, 4, 8, 12, 13, 14, 16, 18, 20, 24, 28, 32, 36,
                        36 + name_len, 36 + name_len + 4 * n_cigar,
                        36 + name_len + 4 * n_cigar + packed],
            "itemsize": rec_size})

    n_ops_of_cls = [1, 2, 2, 3, 3]
    sizes_by_ops = {nc: _rec_dtype(nc)[0] for nc in (1, 2, 3)}
    rec_sizes = np.array([sizes_by_ops[n_ops_of_cls[c]]
                          for c in range(5)], np.int64)[cls]
    w = BamWriter(os.path.join(tmp, "wgs.bam"), [chrom], [chrom_len])
    header = w.header_bytes()
    ustart = np.concatenate([[0], np.cumsum(rec_sizes)]) + len(header)
    n_raw = int(ustart[-1])
    raw = np.empty(n_raw, np.uint8)
    raw[:len(header)] = np.frombuffer(header, np.uint8)
    for nc in (1, 2, 3):
        sel = np.flatnonzero(np.isin(cls, [c for c in range(5)
                                           if n_ops_of_cls[c] == nc]))
        if sel.size == 0:
            continue
        rec_size, rec_dt = _rec_dtype(nc)
        recs = np.zeros(sel.size, rec_dt)
        recs["block_size"] = rec_size - 4
        recs["pos"] = pos0[sel]
        recs["l_name"] = name_len
        recs["mapq"] = 60
        recs["bin"] = bins_all[sel].astype(np.uint16)
        recs["n_cigar"] = nc
        recs["flag"] = flags[sel]
        recs["l_seq"] = read_len
        recs["next_ref"] = -1
        recs["next_pos"] = -1
        recs["name"] = names[sel]
        if nc == 3:
            recs["cigar"] = cigar3[sel]
        else:
            for c in range(3):
                if n_ops_of_cls[c] == nc:
                    recs["cigar"][cls[sel] == c] = cig_ops[c][None, :]
        recs["seq"] = seq_packed[sel]
        recs["qual"] = 30
        if dip.any():
            recs["qual"][dip[sel], read_len - 15:] = 12
        rows = recs.view(np.uint8).reshape(sel.size, rec_size)
        # chunked scatter: a full fancy-index matrix at 10M reads would
        # allocate tens of GB of int64 indices
        offs = ustart[sel]
        CH = 500_000
        for i0 in range(0, sel.size, CH):
            i1 = min(i0 + CH, sel.size)
            idx = offs[i0:i1, None] + np.arange(rec_size)[None, :]
            raw[idx] = rows[i0:i1]
        del recs, rows
    del seq_packed
    out, block_off = bgzf_compress_parallel(raw.tobytes())
    del raw
    with open(w.path, "wb") as f:
        f.write(out)
    del out

    # vectorized .bai: chunk runs per bin + linear index
    blk, within = np.divmod(ustart, 0xFF00)
    voff = (block_off[blk].astype(np.int64) << 16) | within
    ref = RefIndex()
    ref.mapped = n_reads
    bins_arr = bins_all
    cut = np.flatnonzero(np.diff(bins_arr)) + 1
    seg_starts = np.concatenate([[0], cut])
    seg_ends = np.concatenate([cut, [n_reads]])
    for s, e in zip(seg_starts.tolist(), seg_ends.tolist()):
        ref.bins.setdefault(int(bins_arr[s]), []).append(
            (int(voff[s]), int(voff[e])))
    n_win = int((chrom_len - 1) >> LINEAR_SHIFT) + 1
    linear = np.zeros(n_win, np.int64)
    w_beg = (pos0 >> LINEAR_SHIFT).astype(np.int64)
    first = np.searchsorted(w_beg, np.arange(n_win), side="left")
    have = first < n_reads
    linear[have] = voff[np.minimum(first[have], n_reads - 1)]
    # windows whose first covering read starts earlier (spans into them)
    w_end = ((end0 - 1) >> LINEAR_SHIFT).astype(np.int64)
    span = np.flatnonzero(w_end > w_beg)
    for i in span.tolist():
        wE = int(w_end[i])
        if linear[wE] == 0 or voff[i] < linear[wE]:
            linear[wE] = int(voff[i])
    # fill empty windows backward like BaiBuilder (0 means "no smaller")
    ref.linear = linear.tolist()
    write_bai(BamIndex([ref], 0), w.path + ".bai")
    return w.path, gdir


def bench_end_to_end(tmp="/tmp/pisces_tpu_bench", use_device=True):
    """Small single-thread end-to-end run (informational trend line)."""
    from pisces_tpu.io.fasta import Genome
    from pisces_tpu.options import PiscesApplicationOptions
    from pisces_tpu.apps.pisces import process_bam

    bam, gdir = _write_synthetic_workload(tmp, 1, 400_000, 50_000,
                                          variant_rate=0.0)
    o = PiscesApplicationOptions()
    o.output_directory = tmp
    o.vcf_writing_parameters.output_gvcf_file = True
    genome = Genome(gdir)
    t0 = time.perf_counter()
    out = process_bam(o, bam, genome, use_device=use_device)
    dt = time.perf_counter() - t0
    n_reads = 50_000
    lines = sum(1 for l in open(out) if not l.startswith("#"))
    return n_reads / dt, lines / dt


def bench_end_to_end_wes(tmp="/tmp/pisces_tpu_bench_wes", threads: int = 0,
                         use_device: bool = True):
    """Multi-threaded end-to-end wall clock on a WES-scale-shaped synthetic
    workload (multi-chromosome, planted variants, gVCF): the honest proxy
    for BASELINE.md's whole-exome wall-clock target. There is no dotnet
    runtime in this environment, so `dotnet Pisces.dll` cannot be timed
    here; this number is the trend the >=10x target is tracked against,
    with the byte-parity suite pinning equivalence of the output."""
    from pisces_tpu.io.fasta import Genome
    from pisces_tpu.options import PiscesApplicationOptions
    from pisces_tpu.parallel.scheduler import process_bams_parallel

    if threads <= 0:
        # threads <= cores, the reference's own clamp
        # (PiscesApplicationOptions.cs:73-80): oversubscription measured
        # 2.5x slower on a 2-core box
        threads = max(1, min(4, os.cpu_count() or 1))
    n_chroms, chrom_len, n_reads = 4, 600_000, 160_000
    bam, gdir = _write_synthetic_workload(tmp, n_chroms, chrom_len, n_reads,
                                          variant_rate=0.01)
    o = PiscesApplicationOptions()
    o.output_directory = tmp
    o.vcf_writing_parameters.output_gvcf_file = True
    genome = Genome(gdir)
    t0 = time.perf_counter()
    outs = process_bams_parallel(o, [bam], genome, threads,
                                 use_device=use_device)
    dt = time.perf_counter() - t0
    lines = sum(1 for l in open(outs[0]) if not l.startswith("#"))
    return n_reads / dt, lines / dt, dt


def bench_real_bams(tmp="/tmp/pisces_tpu_bench_real", use_device=True):
    """End-to-end timing on the reference's shipped REAL BAMs (indels,
    clips, real base-quality distributions — the data the synthetic bench
    cannot represent). Returns list of (name, reads, wall_s, variants)."""
    from pisces_tpu.io.fasta import Genome
    from pisces_tpu.io.native import open_bam
    from pisces_tpu.options import PiscesApplicationOptions
    from pisces_tpu.apps.pisces import process_bam

    # only chr19 and PhiX ship an actual .fa in the reference tree;
    # Chr17Chr19.bam runs restricted to chr19 (chr17 is skipped exactly the
    # way the reference skips chromosomes absent from the genome,
    # BaseGenomeProcessor.cs:150-155)
    runs = [
        ("Chr17Chr19.bam", os.path.join(SHARED_GENOMES, "chr19"), True),
        ("PhiX_S3.bam",
         os.path.join(SHARED_GENOMES, "PhiX", "WholeGenomeFasta"), True),
    ]
    out = []
    os.makedirs(tmp, exist_ok=True)
    for name, gdir, gvcf in runs:
        bam_path = os.path.join(SHARED_BAMS, name)
        if not (os.path.exists(bam_path) and os.path.exists(gdir)):
            continue
        o = PiscesApplicationOptions()
        o.output_directory = os.path.join(tmp, name.split(".")[0])
        os.makedirs(o.output_directory, exist_ok=True)
        o.vcf_writing_parameters.output_gvcf_file = gvcf
        genome = Genome(gdir)
        reader = open_bam(bam_path)
        n_reads = sum(
            reader.fetch(ref_id=reader.header.ref_index(c)).n
            for c in genome.chromosome_names
            if c in reader.header.ref_names)
        # cold = first call in this process (includes lazy imports + FASTA
        # scan + jit); steady = per-run wall once warm. These BAMs are tiny
        # (1-5k reads), so steady-state is the number comparable to a real
        # WES/WGS run where one-time costs amortize to nothing.
        t0 = time.perf_counter()
        vcf = process_bam(o, bam_path, genome, use_device=use_device)
        cold = time.perf_counter() - t0
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            vcf = process_bam(o, bam_path, genome, use_device=use_device)
        dt = (time.perf_counter() - t0) / iters
        n_lines = sum(1 for l in open(vcf) if not l.startswith("#"))
        out.append((name, int(n_reads), dt, n_lines, cold))
    return out


def bench_candidates(iters: int = CHAIN_ITERS):
    """Device throughput of the fused variant-candidate kernel
    (ops/jax_scoring.score_snv_loci — the AlleleCaller.cs:208-234 hot loop),
    chained on-device like the north-star."""
    import jax
    import jax.numpy as jnp
    from pisces_tpu.ops.jax_scoring import ScoringParams, score_snv_loci

    rng = np.random.default_rng(1)
    n = 1 << 18
    cov_by_dir = rng.integers(0, 400, size=(n, 3)).astype(np.int32)
    sup_by_dir = (cov_by_dir * rng.random((n, 3)) * 0.2).astype(np.int32)
    total = cov_by_dir.sum(axis=1).astype(np.int32)
    ref = (total - sup_by_dir.sum(axis=1)).astype(np.int32)
    nc = rng.integers(0, 5, size=n).astype(np.int32)
    params = ScoringParams()

    @jax.jit
    def run(s, c, r, k, t):
        def body(i, acc):
            out = score_snv_loci(s + (acc & 1), c + (acc & 1), r, k, t, params)
            return out["variant_qscore"].sum() + out["filter_bits"].sum()
        return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

    args = [jax.device_put(x) for x in (sup_by_dir, cov_by_dir, ref, nc, total)]
    with jax.enable_x64(True):  # the kernel computes in float64
        int(run(*args))
        t0 = time.perf_counter()
        v = int(run(*args))
        dt = time.perf_counter() - t0
    assert v != 0
    return n * iters / dt


# ---------------------------------------------------------------------------
# stage runner: every stage executes in a subprocess, one at a time, so a
# native crash or a hung compile cannot take down the metric line and only
# one process holds the device
# ---------------------------------------------------------------------------

def _run_stage(stage: str, timeout_s: int, tail_lines=None) -> bool:
    """Run one informational stage in a subprocess; returns success.
    Stages emit two kinds of lines: "STAGE <verbose>" (relayed live to
    stderr) and "TAIL <short>" (collected into tail_lines and re-printed
    by main() right before the final metric JSON, so the compact block
    survives a capture that keeps only the end of the output)."""
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--stage", stage],
                           capture_output=True, text=True, timeout=timeout_s,
                           cwd=_REPO)
        out = r.stdout + r.stderr
    except subprocess.TimeoutExpired as e:
        partial = e.output or b""
        if isinstance(partial, bytes):
            partial = partial.decode(errors="replace")
        out, r = partial, None
    for line in out.splitlines():
        if line.startswith("STAGE "):
            print(line[6:], file=sys.stderr, flush=True)
        elif line.startswith("TAIL ") and tail_lines is not None:
            tail_lines.append(line[5:])
    if r is None:
        print(f"stage {stage} timed out after {timeout_s}s",
              file=sys.stderr, flush=True)
        return False
    if r.returncode != 0:
        tail = (r.stderr or r.stdout).strip().splitlines()[-2:]
        print(f"stage {stage} failed rc={r.returncode}: {tail}",
              file=sys.stderr, flush=True)
        return False
    return True


def _emit(verbose: str, short: str = None) -> None:
    """Print a verbose STAGE line (live stderr relay) and a compact TAIL
    line (re-printed at the end of main()'s output)."""
    print("STAGE " + verbose, flush=True)
    print("TAIL " + (short if short is not None else verbose), flush=True)


def _stage_main(stage: str) -> None:
    """Child-process entry: run one informational bench, print STAGE lines."""
    device = _device_info()
    use_device = device["platform"] == "gpu"
    backend = f"{device['platform']} {device['device_kind']}"
    if stage == "metric":
        # the device measurement (see main): prints "METRIC <rate> <device
        # json>" for the parent to parse; there is no host fallback
        if not use_device:
            raise SystemExit(f"bench: the metric needs a GPU; JAX's first "
                             f"device is {backend}")
        rng = np.random.default_rng(0)
        L = 1 << 20
        counts = rng.integers(0, 30, size=(L, 6, 3, 11)).astype(np.int32)
        ref_code = rng.integers(0, 4, size=(L,)).astype(np.int32)
        c3 = counts.sum(axis=-1)
        cov_alleles = np.array([0, 1, 2, 3, 5])
        cov_by_dir = c3[:, cov_alleles, :].sum(axis=1).astype(np.int32)
        sup_by_dir = c3[np.arange(L), ref_code, :].astype(np.int32)
        rate = bench_device_chained(sup_by_dir, cov_by_dir)
        print(f"METRIC {rate:.0f} {json.dumps(device)}", flush=True)
        return
    if stage == "e2e":
        e2e_reads, e2e_loci = bench_end_to_end(use_device=use_device)
        _emit(f"end-to-end: {e2e_reads:,.0f} reads/s, {e2e_loci:,.0f} "
              f"gvcf loci/s (single thread, {backend} scoring)",
              f"e2e 1thr: {e2e_reads:,.0f} r/s {e2e_loci:,.0f} loci/s "
              f"({backend})")
    elif stage == "wes":
        host_r, host_l, host_w = bench_end_to_end_wes(use_device=False)
        n_thr = max(1, min(4, os.cpu_count() or 1))
        _emit(f"WES-scale e2e (4 chrom, 160k MESSY reads — ~1% CIGAR "
              f"indels, ~10% softclips, quality dips — planted variants, "
              f"{n_thr} threads, host scoring): {host_w:.1f}s wall = "
              f"{host_r:,.0f} reads/s, {host_l:,.0f} gvcf loci/s. "
              f"NOTE: no dotnet runtime here; BASELINE.md's >=10x target "
              f"is tracked via this committed per-round trend.",
              f"WES messy {n_thr}thr host: {host_w:.1f}s "
              f"{host_r:,.0f} r/s {host_l:,.0f} loci/s")
        if use_device:
            wes_reads, wes_loci, wes_wall = bench_end_to_end_wes(
                use_device=True)
            _emit(f"WES-scale e2e ({backend} scoring): "
                  f"{wes_wall:.1f}s wall = {wes_reads:,.0f} reads/s",
                  f"WES messy {backend}: {wes_wall:.1f}s "
                  f"{wes_reads:,.0f} r/s")
    elif stage == "real":
        for name, n_reads, dt, n_lines, cold in bench_real_bams(
                use_device=use_device):
            _emit(f"real-data e2e {name}: {n_reads:,} reads in "
                  f"{dt:.3f}s steady-state = {n_reads / dt:,.0f} reads/s "
                  f"(cold first-run {cold:.2f}s = {n_reads / cold:,.0f} "
                  f"reads/s), {n_lines} vcf lines ({backend} scoring)",
                  f"{name}: {n_reads / dt:,.0f} r/s steady, cold "
                  f"{cold:.2f}s, {n_lines} lines ({backend})")
    elif stage == "scylla":
        import shutil

        from pisces_tpu.phasing.scylla import main as scylla_main

        SD = ("/root/reference/src/test/Scylla.Tests/TestData")
        tmp = "/tmp/pisces_tpu_bench_scylla"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        t0 = time.perf_counter()
        scylla_main(["-bam", os.path.join(SHARED_BAMS, "Bcereus_S4.bam"),
                     "-vcf", os.path.join(SD, "Bcereus_S4.vcf"),
                     "-out", tmp])
        dt = time.perf_counter() - t0
        n = sum(1 for l in open(os.path.join(tmp, "Bcereus_S4.phased.vcf"))
                if not l.startswith("#"))
        _emit(f"scylla phasing (real Bcereus_S4): {dt:.2f}s, "
              f"{n} output lines (full-file oracle parity pinned in tests)",
              f"scylla Bcereus: {dt:.2f}s {n} lines")
    elif stage == "gemini":
        import shutil

        from pisces_tpu.io.bam import BamReader
        from pisces_tpu.preprocessing.gemini import run_gemini

        src = os.path.join(SHARED_BAMS, "Chr17Chr19.bam")
        gdir = os.path.join(SHARED_GENOMES, "chr19")
        tmp = "/tmp/pisces_tpu_bench_gemini"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        bam = os.path.join(tmp, "in.bam")
        shutil.copy(src, bam)
        n_reads = BamReader(bam).fetch(None).n
        t0 = time.perf_counter()
        out = run_gemini(bam, gdir, os.path.join(tmp, "out.bam"))
        cold = time.perf_counter() - t0
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run_gemini(bam, gdir, os.path.join(tmp, "out.bam"))
        dt = (time.perf_counter() - t0) / iters
        n_out = BamReader(out).fetch(None).n
        _emit(f"gemini preprocess (stitch+realign, real "
              f"Chr17Chr19.bam): {n_reads:,} reads in {dt:.3f}s "
              f"steady-state = {n_reads / dt:,.0f} reads/s (cold first-run "
              f"{cold:.2f}s = {n_reads / cold:,.0f} reads/s), "
              f"{n_out:,} reads out",
              f"gemini Chr17Chr19: {n_reads / dt:,.0f} r/s steady, "
              f"cold {cold:.2f}s")
        # realigner-engaged arm: recurrent planted indels (40% carrier VF,
        # half written misaligned as clean-M) force the native realigner
        # core (io/_native/realign.cpp) through its hot path
        from pisces_tpu.preprocessing.gemini import GeminiOptions
        from pisces_tpu.io.bam_write import BamWriter
        from pisces_tpu.io.fasta import create_genome_size_xml, write_fai
        import random as _random
        rng2 = _random.Random(21)
        rtmp = os.path.join(tmp, "realign_corpus")
        os.makedirs(os.path.join(rtmp, "genome"), exist_ok=True)
        clen, rl, n_r = 15_000, 80, 8_000
        refs = "".join(rng2.choice("ACGT") for _ in range(clen))
        with open(os.path.join(rtmp, "genome", "chrR.fa"), "w") as f:
            f.write(">chrR\n")
            for i in range(0, clen, 70):
                f.write(refs[i:i + 70] + "\n")
        write_fai(os.path.join(rtmp, "genome", "chrR.fa"))
        create_genome_size_xml(os.path.join(rtmp, "genome"))
        sites = [(2000 + k * 1200, k % 2 == 0) for k in range(10)]
        ins_of = {p: "".join(rng2.choice("ACGT") for _ in range(2))
                  for p, ii in sites if ii}
        rb = os.path.join(rtmp, "r.bam")
        w = BamWriter(rb, ["chrR"], [clen])
        for i in range(n_r):
            p = rng2.randint(1, clen - rl - 4)
            sq = list(refs[p - 1:p - 1 + rl])
            cg = f"{rl}M"
            for sp, ii in sites:
                off = sp - p
                if 10 <= off < rl - 12 and rng2.random() < 0.4:
                    if ii:
                        sq = (sq[:off + 1] + list(ins_of[sp])
                              + sq[off + 1:])[:rl]
                        if rng2.random() < 0.5:
                            cg = f"{off + 1}M2I{rl - off - 3}M"
                    else:
                        sq = (sq[:off + 1] + sq[off + 3:]
                              + list(refs[p - 1 + rl:p - 1 + rl + 2]))[:rl]
                        if rng2.random() < 0.5:
                            cg = f"{off + 1}M2D{rl - off - 1}M"
                    break
            w.add_read(f"r{i}", "chrR", p, cg, "".join(sq),
                       flag=0x10 if i & 1 else 0)
        w.write()
        gopts = GeminiOptions(use_bin_signal=False)
        run_gemini(rb, os.path.join(rtmp, "genome"),
                   os.path.join(rtmp, "out.bam"), options=gopts)  # warm
        t0 = time.perf_counter()
        for _ in range(3):
            run_gemini(rb, os.path.join(rtmp, "genome"),
                       os.path.join(rtmp, "out.bam"), options=gopts)
        rdt = (time.perf_counter() - t0) / 3
        _emit(f"gemini realigner-engaged corpus (8k reads, 10 recurrent "
              f"indel sites, native realign.cpp core): {rdt:.3f}s = "
              f"{n_r / rdt:,.0f} reads/s",
              f"gemini realign-heavy: {n_r / rdt:,.0f} r/s")
    elif stage == "titration":
        # host scoring: an accuracy arm, and accuracy is identical on
        # either backend (byte parity pinned in tests)
        from pisces_tpu.apps.titration import run_titration
        t0 = time.perf_counter()
        points = run_titration("/tmp/pisces_tpu_bench_titr",
                               sites_per_point=25, depth=800,
                               use_device=False)
        dt = time.perf_counter() - t0
        parts = "; ".join(
            f"VF {p.vf:.0%}: R {p.recall:.2f} P {p.precision:.2f}"
            for p in sorted(points.values(), key=lambda p: p.vf))
        _emit(f"somatic titration accuracy (planted truth, canonical "
              f"somatic flags, host scoring, {dt:.0f}s): {parts}",
              f"titration: {parts}")
    elif stage == "lowvf":
        # the paper's low-VF operating regime (run_analysis.sh:84-135) at
        # STATISTICAL scale: >=100 planted sites per VF point on the
        # 1/1.5/2% ladder, Wilson CIs on recall;
        # deep targeted depth + noise model matched to the Q30 floor
        from pisces_tpu.apps.titration import run_titration
        t0 = time.perf_counter()
        deep = run_titration("/tmp/pisces_tpu_bench_lowvf",
                             vf_points=(0.01, 0.015, 0.02),
                             sites_per_point=100, depth=2000, min_bq=30,
                             chrom_len=70_000, use_device=False, seed=19)
        dt = time.perf_counter() - t0
        parts = "; ".join(
            f"VF {p.vf:.1%}: R {p.recall:.2f} "
            f"[{p.recall_ci[0]:.2f},{p.recall_ci[1]:.2f}] "
            f"P {p.precision:.2f} n={p.n_sites}"
            for p in sorted(deep.values(), key=lambda p: p.vf))
        _emit(f"low-VF somatic titration (depth 2000x, -minbq 30 -> NL 30, "
              f"100 sites/point, 95% Wilson CI, {dt:.0f}s): {parts}",
              f"lowVF 2000x n=100/pt: {parts}")
    elif stage == "germline":
        # hap.py-analog germline arm (run_analysis.sh:142+): diploid
        # thresholding AND adaptive models, genotype-aware scoring
        from pisces_tpu.apps.accuracy import run_germline
        t0 = time.perf_counter()
        thr = run_germline("/tmp/pisces_tpu_bench_germ", seed=11)
        ada = run_germline("/tmp/pisces_tpu_bench_germ_a", adaptive=True,
                           seed=11)
        dt = time.perf_counter() - t0
        parts = "; ".join(
            f"{m} {z}: R {r[z].recall:.2f} P {r[z].precision:.2f} "
            f"GT {r[z].gt_concordance:.2f}"
            for m, r in (("thr", thr), ("adpt", ada))
            for z in ("het", "hom"))
        _emit(f"germline accuracy (planted het/hom SNV+indel truth, "
              f"genotype-aware hap.py-style scoring, {dt:.0f}s): {parts}",
              f"germline: {parts}")
    elif stage == "mnv":
        # phased-MNV accuracy: direct -CallMNVs AND the Pisces->Scylla
        # 2-stage flow on planted multi-site haplotypes
        from pisces_tpu.apps.accuracy import run_mnv_accuracy
        t0 = time.perf_counter()
        direct = run_mnv_accuracy("/tmp/pisces_tpu_bench_mnv", mode="mnv",
                                  seed=13)
        phased = run_mnv_accuracy("/tmp/pisces_tpu_bench_mnv_s",
                                  mode="scylla", seed=13)
        dt = time.perf_counter() - t0
        _emit(f"phased-MNV accuracy (planted 2-3-site haplotypes, "
              f"{dt:.0f}s): CallMNVs R {direct.recall:.2f} "
              f"P {direct.precision:.2f} (n={direct.n_truth}); "
              f"Scylla R {phased.recall:.2f} P {phased.precision:.2f}",
              f"MNV: direct R {direct.recall:.2f} P {direct.precision:.2f};"
              f" scylla R {phased.recall:.2f} P {phased.precision:.2f} "
              f"n={direct.n_truth}")
    elif stage == "wgs":
        # WGS-scale bounded-memory streaming proof: ~10M reads / 33Mb
        # chromosome (~30x) through -WindowSize slices; reports wall,
        # reads/s and peak RSS (the reference's block-recycling analog,
        # RegionStateManager.cs:336-439)
        import resource

        from pisces_tpu.io.fasta import Genome
        from pisces_tpu.options import PiscesApplicationOptions
        from pisces_tpu.apps.pisces import process_bam

        n_reads = 10_000_000
        tmp = "/tmp/pisces_tpu_bench_wgs"
        # generate in a CHILD process so this process's peak RSS measures
        # the streaming pipeline, not the ~6 GB vectorized generator
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--stage", "wgs-gen"], cwd=_REPO,
                               capture_output=True, text=True, timeout=700)
        except subprocess.TimeoutExpired:
            print("STAGE WGS-scale streaming e2e: workload generation "
                  "exceeded 700s on this run (host CPU-steal variance; "
                  "generation measured 119-247s on quiet runs) — stage "
                  "skipped", flush=True)
            return
        if r.returncode != 0:
            raise RuntimeError(f"wgs-gen failed: {r.stderr[-1500:]}")
        gen_s = time.perf_counter() - t0
        bam = os.path.join(tmp, "wgs.bam")
        gdir = os.path.join(tmp, "genome")
        o = PiscesApplicationOptions()
        o.output_directory = tmp
        o.vcf_writing_parameters.output_gvcf_file = True
        o.window_size = 2_000_000
        genome = Genome(gdir)
        t0 = time.perf_counter()
        vcf = process_bam(o, bam, genome, use_device=False)
        dt = time.perf_counter() - t0
        n_lines = sum(1 for l in open(vcf) if not l.startswith("#"))
        peak_gb = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / (1024 ** 2)
        _emit(f"WGS-scale streaming e2e (-WindowSize 2M, 1 chrom, "
              f"{n_reads:,} MESSY reads (~1% indels, ~10% softclips), "
              f"33Mb, ~30x): {dt:.1f}s wall = "
              f"{n_reads / dt:,.0f} reads/s, {n_lines:,} gvcf lines, "
              f"peak RSS {peak_gb:.1f} GB (workload generated in a child "
              f"process, {gen_s:.0f}s), host scoring",
              f"WGS messy 10M reads: {dt:.0f}s {n_reads / dt:,.0f} r/s "
              f"RSS {peak_gb:.1f}GB")
    elif stage == "wgs-gen":
        generate_wgs_workload("/tmp/pisces_tpu_bench_wgs")
        print("STAGE wgs-gen done", flush=True)
    elif stage == "multihost":
        # REAL 2-process jax.distributed run on this box (CPU backend):
        # coordinator join, LPT chromosome partition, atomic shards, merge
        # barrier — byte-compared against the single-process run
        from pisces_tpu.options import PiscesApplicationOptions
        from pisces_tpu.parallel.multihost import (
            process_bam_multihost, run_local_multihost,
        )
        tmp = "/tmp/pisces_tpu_bench_mh"
        bam, gdir = _write_synthetic_workload(os.path.join(tmp, "wl"),
                                              2, 200_000, 40_000)
        t0 = time.perf_counter()
        merged = run_local_multihost(bam, gdir, os.path.join(tmp, "mh"),
                                     n_procs=2, timeout_s=400)
        dt = time.perf_counter() - t0
        o = PiscesApplicationOptions()
        o.output_directory = os.path.join(tmp, "sp")
        os.makedirs(o.output_directory, exist_ok=True)
        o.vcf_writing_parameters.output_gvcf_file = True
        single = process_bam_multihost(o, bam, gdir, use_device=False)
        la = [l for l in open(single) if not l.startswith("##")]
        lb = [l for l in open(merged) if not l.startswith("##")]
        # elastic-recovery arm: SIGKILL worker 1 after its first shard; a
        # recoverable host 0 must work-steal the dead worker's remaining
        # chromosomes and still byte-match (reference: the parent reaps
        # crashed -InsideSubProcess children, CliTask.cs:55-90)
        bam4, gdir4 = _write_synthetic_workload(os.path.join(tmp, "wl4"),
                                                4, 100_000, 30_000)
        t0 = time.perf_counter()
        merged_k = run_local_multihost(bam4, gdir4, os.path.join(tmp, "mhk"),
                                       n_procs=2, timeout_s=300,
                                       kill_worker=1, recover_stall_s=5,
                                       delay_per_chr=3)
        dtk = time.perf_counter() - t0
        ok = PiscesApplicationOptions()
        ok.output_directory = os.path.join(tmp, "spk")
        os.makedirs(ok.output_directory, exist_ok=True)
        ok.vcf_writing_parameters.output_gvcf_file = True
        single_k = process_bam_multihost(ok, bam4, gdir4, use_device=False)
        ka = [l for l in open(single_k) if not l.startswith("##")]
        kb = [l for l in open(merged_k) if not l.startswith("##")]
        _emit(f"multihost (REAL jax.distributed, 2 coordinator-joined "
              f"processes, CPU backend): process_count=2 "
              f"vcf_lines={len(lb)} byte_equal={la == lb} wall={dt:.1f}s; "
              f"SIGKILL-worker-1 recovery arm: byte_equal={ka == kb} "
              f"wall={dtk:.1f}s",
              f"multihost real 2-proc: byte_equal={la == lb} "
              f"wall={dt:.1f}s; SIGKILL recovery byte_equal={ka == kb} "
              f"wall={dtk:.1f}s")
    elif stage == "candidates":
        rate = bench_candidates()
        _emit(f"candidate-path kernel: {rate:,.0f} candidates/s/chip "
              f"(fused score_snv_loci, chained, {backend})",
              f"XLA candidates kernel: {rate:,.0f} cand/s ({backend})")
    else:
        raise SystemExit(f"unknown stage {stage}")


def _cpu_sample():
    """(busy_ticks, steal_ticks, total_ticks) from /proc/stat; zeros if
    unavailable. Annotates the JSON with the host's contention during the
    run, so a slower line can be told from a busy neighbor."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        vals = [int(x) for x in parts[1:]]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
        steal = vals[7] if len(vals) > 7 else 0
        return sum(vals) - idle, steal, sum(vals)
    except Exception:
        return 0, 0, 0


def main():
    # this environment sets PYTHONDONTWRITEBYTECODE=1, so every process
    # re-compiles every module from source (~20ms of the cold first-run on
    # lazy imports alone). compileall writes the .pyc cache explicitly;
    # all stage subprocesses then import from bytecode.
    subprocess.run([sys.executable, "-m", "compileall", "-q",
                    os.path.join(_REPO, "pisces_tpu")],
                   capture_output=True, timeout=120)

    rng = np.random.default_rng(0)
    L = 1 << 20  # 1M loci per tile
    counts = rng.integers(0, 30, size=(L, 6, 3, 11)).astype(np.int32)
    ref_code = rng.integers(0, 4, size=(L,)).astype(np.int32)
    c3 = counts.sum(axis=-1)
    cov_alleles = np.array([0, 1, 2, 3, 5])
    cov_by_dir = c3[:, cov_alleles, :].sum(axis=1).astype(np.int32)
    sup_by_dir = c3[np.arange(L), ref_code, :].astype(np.int32)

    host_rate = bench_host(counts[: L // 8], ref_code[: L // 8])

    # The device metric runs in a subprocess, so this process never
    # initializes JAX; no METRIC line (no GPU, a crash, a timeout) fails
    # the benchmark.
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--stage", "metric"], capture_output=True, text=True,
                       timeout=900, cwd=_REPO)
    lines = [l for l in r.stdout.splitlines() if l.startswith("METRIC ")]
    if not lines:
        tail = (r.stderr or r.stdout).strip().splitlines()[-3:]
        print(f"bench: the metric stage produced no METRIC line "
              f"(rc={r.returncode}): {tail}", file=sys.stderr, flush=True)
        raise SystemExit(1)
    _, rate_s, device_s = lines[0].split(" ", 2)
    device_rate = float(rate_s)
    device = json.loads(device_s)

    # pipeline-utilization companion numbers: the
    # kernel's steady-state rate is only meaningful next to what the full
    # bam->gVCF pipeline actually feeds it, so both ride the JSON line.
    # Host scoring, in this process: it never touches the device.
    e2e_loci_per_s = 0.0
    try:
        bench_end_to_end(use_device=False)  # warm (imports, FASTA, jit)
        for _ in range(2):  # best of 2
            _, rate = bench_end_to_end(use_device=False)
            e2e_loci_per_s = max(e2e_loci_per_s, rate)
    except Exception as e:
        print(f"utilization e2e failed ({e})", file=sys.stderr, flush=True)

    metric = {
        "metric": "candidate loci scored/sec/chip",
        "value": round(device_rate),
        "unit": "loci/s",
        "vs_baseline": round(device_rate / host_rate, 2),
        "device": device,
        "e2e_loci_per_s": round(e2e_loci_per_s),
        "kernel_utilization_pct": round(
            100.0 * e2e_loci_per_s / max(device_rate, 1), 4),
    }
    # a first copy, in case a stage takes the process down; the final copy
    # is printed last
    print(json.dumps(metric), flush=True)

    cpu0 = _cpu_sample()
    t_run0 = time.perf_counter()
    tail_lines = []
    for stage, timeout_s in [("real", 240), ("gemini", 240),
                             ("titration", 240), ("lowvf", 600),
                             ("germline", 300), ("mnv", 300),
                             ("multihost", 300),
                             ("e2e", 240), ("wes", 300), ("scylla", 180),
                             ("wgs", 1000), ("candidates", 480)]:
        _run_stage(stage, timeout_s, tail_lines=tail_lines)

    # contention annotation for the whole stage run: tells a regression
    # from a busy host
    cpu1 = _cpu_sample()
    d_total = max(cpu1[2] - cpu0[2], 1)
    metric["steal_pct"] = round(100.0 * (cpu1[1] - cpu0[1]) / d_total, 2)
    metric["host_busy_pct"] = round(100.0 * (cpu1[0] - cpu0[0]) / d_total, 2)
    try:
        metric["load1"] = float(open("/proc/loadavg").read().split()[0])
    except Exception:
        pass
    metric["stage_wall_s"] = round(time.perf_counter() - t_run0)

    # compact summary block + the metric line, last: they survive a capture
    # that keeps only the end of the output
    for line in tail_lines:
        print(line[:199], flush=True)
    print(json.dumps(metric), flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        _stage_main(sys.argv[2])
    else:
        main()
