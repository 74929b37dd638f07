"""Multi-device region sharding: the production distributed scoring step.

Maps the reference's parallelism inventory (SURVEY §2.5) onto a JAX device
mesh:
  - 'dp' (data parallel)   ~ independent region-tile batches, the analog of
    thread-per-(bam,chr) jobs (BaseGenomeProcessor.cs:40-135)
  - 'sp' (sequence parallel) ~ the genomic position axis, the analog of
    1000-bp RegionState blocks streamed in order.

The genome position axis is row-sharded over the flattened (dp, sp) device
ring. Reads are routed to the shard owning their START position (the same
ownership rule as the reference's read-to-block ingestion,
RegionStateManager.AddAlleleCounts, cs:118-220); each shard scatter-adds a
PARTIAL count buffer covering [shard_start, shard_end + halo). Events of a
read that extend past the shard's right edge land in the halo tail, which a
ppermute ring-shift delivers to the right neighbor before scoring — the
device-native form of the reference's block-boundary hold-and-spill
(RegionStateManager.GetCandidatesToProcess holding blocks whose
MaxAlleleEndpoint spills forward, cs:303-314). Only after the halo add does
each shard score its own positions with the fused per-locus kernel; global
summary counts ride psum over both mesh axes.

This is the step `dryrun_multichip` compiles and the step `-MeshDevices N`
executes in production (apps/pisces.py fast-gVCF path); byte-parity of its
VCF output vs single-device execution is asserted in tests/test_sharded.py.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pisces_tpu.domain.types import (
    BASE_TO_ALLELE, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES,
)
from pisces_tpu.ops.jax_scoring import ScoringParams, score_reference_tuples
from pisces_tpu.pileup.events import BaseEvents

_AD = NUM_ALLELE_TYPES * NUM_DIRECTION_TYPES  # 18


def factor_mesh(n: int) -> Tuple[int, int]:
    """Factor n devices into (dp, sp), preferring a balanced 2D mesh."""
    best = (1, n)
    for dp in range(1, int(n ** 0.5) + 1):
        if n % dp == 0:
            best = (dp, n // dp)
    return best


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    dp, sp = factor_mesh(len(devices))
    dev_array = np.array(devices).reshape(dp, sp)
    return Mesh(dev_array, axis_names=("dp", "sp"))


_mesh_cache: dict = {}


def get_mesh(n_devices: int) -> Mesh:
    """Mesh over the first n_devices devices, cached per size."""
    m = _mesh_cache.get(n_devices)
    if m is None:
        devs = jax.devices()
        if n_devices > len(devs):
            raise ValueError(f"-MeshDevices {n_devices} > available "
                             f"{len(devs)} devices")
        m = make_mesh(devs[:n_devices])
        _mesh_cache[n_devices] = m
    return m


# ---------------------------------------------------------------------------
# Geometry + host-side read routing
# ---------------------------------------------------------------------------

class ShardGeometry:
    """Position-axis shard layout for one chromosome domain.

    domain_start: 1-based genomic position of local index 0
    l_local: positions owned per shard; l_pad = n_shards * l_local
    halo: positions past each shard's right edge its partial buffer covers
    """

    def __init__(self, domain_start: int, l_local: int, halo: int,
                 n_shards: int):
        self.domain_start = domain_start
        self.l_local = l_local
        self.halo = halo
        self.n_shards = n_shards
        self.l_pad = n_shards * l_local


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_shards(ev: BaseEvents, n_shards: int,
                min_halo: int = 128) -> Optional[ShardGeometry]:
    """Choose the shard geometry for an event stream.

    Reads own the shard containing their start; the halo must cover the
    furthest any read's events reach past its owner's right edge. Returns
    None when the domain is too small to shard safely (halo would exceed
    l_local — a read could span more than one neighbor, which the
    single-ring-shift halo cannot represent)."""
    if len(ev.gpos) == 0 or n_shards < 1:
        return None
    lo = int(ev.read_start.min())
    hi = int(ev.gpos.max())
    span = hi - lo + 1
    l_local = _round_up(max(1, -(-span // n_shards)), 256)
    # how far events reach past their read's start
    reach = int((ev.gpos - ev.read_start).max()) + 1
    halo = max(min_halo, 1 << (reach - 1).bit_length())
    if halo >= l_local:
        # grow shards until the halo fits (may underfill trailing shards)
        l_local = _round_up(halo + 256, 256)
    return ShardGeometry(lo, l_local, halo, n_shards)


def build_partial_counts(ev: BaseEvents, geo: ShardGeometry) -> np.ndarray:
    """Scatter events into per-owner-shard PARTIAL count buffers.

    Returns int32 [n_shards * (l_local + halo), 6, 3]. Events whose position
    falls past their owner's right edge land in the owner's halo tail rows
    (indices >= l_local); the device step ships those to the right neighbor.
    The scatter is a pure commutative integer sum, so the sharded total
    after the halo add is bit-identical to the single-buffer scatter.
    """
    width = geo.l_local + geo.halo
    owner = (ev.read_start - geo.domain_start) // geo.l_local
    local = ev.gpos - geo.domain_start - owner * geo.l_local
    if len(local) and (int(local.max()) >= width or int(local.min()) < 0):
        raise AssertionError("event outside its owner shard's halo window")
    lin = ((owner * width + local) * NUM_ALLELE_TYPES
           + ev.allele.astype(np.int64)) * NUM_DIRECTION_TYPES \
        + ev.direction.astype(np.int64)
    size = geo.n_shards * width * _AD
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    uniq, start = np.unique(lin_s, return_index=True)
    counts_u = np.diff(np.append(start, len(lin_s)))
    flat = np.zeros(size, np.int32)
    flat[uniq] = counts_u
    return flat.reshape(geo.n_shards * width, NUM_ALLELE_TYPES,
                        NUM_DIRECTION_TYPES)


# ---------------------------------------------------------------------------
# The distributed device step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _build_step(mesh: Mesh, params: ScoringParams, l_local: int, halo: int):
    """shard_map'd production step: halo exchange + fused per-locus scoring
    + psum'd global summaries. Cached per (mesh, params, geometry)."""
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    cov_alleles = jnp.array([0, 1, 2, 3, 5])  # A,C,G,T,Del

    def local_fn(partial, ref_code):
        # partial: [l_local + halo, 6, 3] this shard's partial counts
        # ref_code: [l_local] reference allele codes for owned positions
        tail = partial[l_local:]
        # ring shift right over the flattened (dp, sp) shard order:
        # global shard id = dp_idx * n_sp + sp_idx
        perm_sp = [(i, (i + 1) % n_sp) for i in range(n_sp)]
        t1 = jax.lax.ppermute(tail, "sp", perm_sp)
        perm_dp = [(i, (i + 1) % n_dp) for i in range(n_dp)]
        t2 = jax.lax.ppermute(t1, "dp", perm_dp)
        sp_i = jax.lax.axis_index("sp")
        dp_i = jax.lax.axis_index("dp")
        recv = jnp.where(sp_i == 0, t2, t1)
        gid = dp_i * n_sp + sp_i
        recv = jnp.where(gid == 0, jnp.zeros_like(recv), recv)
        counts = partial[:l_local].at[:halo].add(recv)   # [l_local, 6, 3]

        cov_by_dir = counts[:, cov_alleles, :].sum(axis=1)
        l_idx = jnp.arange(l_local)
        sup_by_dir = counts[l_idx, ref_code.astype(jnp.int32), :]
        out = score_reference_tuples(sup_by_dir, cov_by_dir, params)
        touched = counts.sum(axis=(1, 2))
        called = jnp.sum((out["variant_qscore"] >= params.min_variant_qscore)
                         & (touched > 0))
        called = jax.lax.psum(jax.lax.psum(called, "sp"), "dp")
        covered = jax.lax.psum(jax.lax.psum(
            jnp.sum(out["total_coverage"] > 0), "sp"), "dp")
        return (touched.astype(jnp.int32), out["total_coverage"],
                out["support"], sup_by_dir, cov_by_dir,
                out["variant_qscore"], out["genotype"], out["gq"],
                out["sb_gatk"], called, covered)

    pos_spec = P(("dp", "sp"))
    step = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(pos_spec, pos_spec),
        out_specs=(pos_spec, pos_spec, pos_spec, pos_spec, pos_spec,
                   pos_spec, pos_spec, pos_spec, pos_spec, P(), P()),
    )
    return jax.jit(step)


@functools.lru_cache(maxsize=32)
def _build_snv_step(mesh: Mesh, params: ScoringParams):
    """shard_map'd candidate scoring: the fused score_snv_loci kernel
    row-sharded over the flattened (dp, sp) device ring. Candidate tuples
    are complete after host aggregation (single-point coverage semantics,
    AlleleCaller.cs:208-234), so this is pure data parallelism — the mesh
    analog of the reference's per-candidate scoring inside each (bam, chr)
    job (P1)."""
    from pisces_tpu.ops.jax_scoring import score_snv_loci

    spec = P(("dp", "sp"))

    def local_fn(sup, cov, ref_sup, nc, total):
        return score_snv_loci(sup, cov, ref_sup, nc, total, params)

    step = jax.shard_map(local_fn, mesh=mesh,
                         in_specs=(spec, spec, spec, spec, spec),
                         out_specs=spec)
    return jax.jit(step)


def sharded_score_snv_tuples(sup_by_dir, cov_by_dir, ref_support,
                             num_no_calls, total_coverage,
                             params: ScoringParams, mesh: Mesh):
    """Score a candidate batch over the device mesh; returns the
    score_snv_loci output dict as numpy arrays trimmed to the input length.
    Padding rows are zero tuples, which the kernel maps to q=0 — discarded
    by the trim."""
    n = len(total_coverage)
    shards = mesh.devices.size
    unit = shards * 128
    pad = max(unit, ((n + unit - 1) // unit) * unit)

    def _pad(a, width=None):
        a = np.asarray(a, np.int32)
        shape = (pad,) if width is None else (pad, width)
        out = np.zeros(shape, np.int32)
        out[:n] = a
        return out

    sharding = NamedSharding(mesh, P(("dp", "sp")))
    args = [jax.device_put(x, sharding) for x in
            (_pad(sup_by_dir, 3), _pad(cov_by_dir, 3), _pad(ref_support),
             _pad(num_no_calls), _pad(total_coverage))]
    # the kernel computes in float64 (ops/jax_scoring), so the whole
    # shard_map step is traced with it enabled
    with jax.enable_x64(True):
        out = _build_snv_step(mesh, params)(*args)
    return {k: np.asarray(v)[:n] for k, v in out.items()}


def sharded_score_reference_positions(ev: BaseEvents, refseq: np.ndarray,
                                      params: ScoringParams, mesh: Mesh,
                                      intervals=None):
    """Production mesh execution of the dense gVCF reference-locus scoring.

    Routes reads to position shards, builds partial count buffers, runs the
    halo-exchange + fused-scoring step over the mesh, and returns
    (positions, out) in the exact shape fast_gvcf.format_reference_lines
    consumes (unique-tuple outputs + inverse index), byte-compatible with
    the single-device path. Returns (positions, None, stats) when there is
    nothing to score; stats carries the psum'd global summaries.
    """
    n_shards = mesh.devices.size
    geo = plan_shards(ev, n_shards)
    if geo is None:
        return np.empty(0, np.int64), None, {}
    partial = build_partial_counts(ev, geo)
    width = geo.l_local + geo.halo

    # reference codes for every owned position (clamped into the sequence;
    # out-of-sequence padding rows are untouched and masked out below)
    positions = geo.domain_start + np.arange(geo.l_pad, dtype=np.int64)
    safe_pos = np.clip(positions, 1, len(refseq))
    ref_codes = BASE_TO_ALLELE[refseq[safe_pos - 1]].astype(np.int32)

    step = _build_step(mesh, params, geo.l_local, geo.halo)
    pos_sharding = NamedSharding(mesh, P(("dp", "sp")))
    partial_d = jax.device_put(partial, pos_sharding)
    ref_d = jax.device_put(ref_codes, pos_sharding)
    with jax.enable_x64(True):
        (touched, total_cov, support, sup_by_dir, cov_by_dir, q, gt, gq,
         sb_gatk, called, covered) = step(partial_d, ref_d)

    touched = np.asarray(touched)
    stats = {"loci_called": int(called), "loci_covered": int(covered)}

    pad_flag = None
    if intervals is None:
        in_ref = positions <= len(refseq)
        sel = (touched > 0) & in_ref
        positions = positions[sel]
        if len(positions) == 0:
            return positions, None, stats
        sup3 = np.asarray(sup_by_dir)[sel]
        cov3 = np.asarray(cov_by_dir)[sel]
        vals = {
            "total_coverage": np.asarray(total_cov)[sel],
            "support": np.asarray(support)[sel],
            "variant_qscore": np.asarray(q)[sel],
            "genotype": np.asarray(gt)[sel],
            "gq": np.asarray(gq)[sel],
            "sb_gatk": np.asarray(sb_gatk)[sel],
        }
    else:
        # interval mode: EVERY interval position is emitted, padded rows
        # (outside any touched 1000-bp block) carry the RegionMapper
        # semantics (distinct NL) exactly like the single-device fast path
        from pisces_tpu.domain.types import Genotype
        from pisces_tpu.options import REGION_SIZE
        ranges = intervals.clipped_ranges(1, len(refseq))
        if not ranges:
            return np.empty(0, np.int64), None, stats
        int_pos = np.concatenate(
            [np.arange(rs, re_ + 1, dtype=np.int64) for rs, re_ in ranges])
        in_domain = (int_pos >= geo.domain_start) \
            & (int_pos < geo.domain_start + geo.l_pad)
        idx = np.where(in_domain, int_pos - geo.domain_start, 0)

        def gather(arr, zero):
            a = np.asarray(arr)
            out_a = a[idx]
            if out_a.ndim == 1:
                return np.where(in_domain, out_a, zero)
            return np.where(in_domain[:, None], out_a, zero)

        sup3 = gather(sup_by_dir, 0)
        cov3 = gather(cov_by_dir, 0)
        # zero-tuple outputs are forced by explicit masks in the kernel
        # (total==0 => q 0, gq min_gq, REF_LIKE_NOCALL, sb 0.0), so the
        # out-of-domain substitutes are exact
        vals = {
            "total_coverage": gather(total_cov, 0),
            "support": gather(support, 0),
            "variant_qscore": gather(q, 0),
            "genotype": gather(gt, int(Genotype.REF_LIKE_NOCALL)),
            "gq": gather(gq, params.min_gq),
            "sb_gatk": gather(sb_gatk, np.float32(0.0)),
        }
        # padding = outside any TOUCHED genome-aligned 1000-bp block
        # (matches pc.pos_index(pos) < 0 in the single-device path)
        block_keys = (positions + REGION_SIZE - 1) // REGION_SIZE
        touched_blocks = np.unique(block_keys[touched > 0])
        int_blocks = (int_pos + REGION_SIZE - 1) // REGION_SIZE
        bi = np.searchsorted(touched_blocks, int_blocks)
        bi = np.minimum(bi, max(len(touched_blocks) - 1, 0))
        in_touched = (len(touched_blocks) > 0) \
            & (touched_blocks[bi] == int_blocks)
        pad_flag = (~in_touched).astype(np.int64)
        positions = int_pos

    # Collapse to unique (sup_by_dir, cov_by_dir[, padding]) tuples so line
    # formatting memoizes per tuple exactly like the single-device fast
    # path; every scored value is a pure function of the tuple, so the
    # representative (first-occurrence) row carries the unique value.
    cols = [sup3, cov3]
    if pad_flag is not None:
        cols.append(pad_flag.reshape(-1, 1))
    key = np.concatenate(cols, axis=1)
    k = key.shape[1]
    hi = int(key[:, :6].max(initial=0))
    if 0 <= int(key.min(initial=0)) and hi < (1 << 10):
        packed = np.zeros(len(key), dtype=np.int64)
        for j in range(6):
            packed = (packed << 10) | key[:, j].astype(np.int64)
        if k > 6:
            packed = (packed << 1) | key[:, 6].astype(np.int64)
        _, first, inv = np.unique(packed, return_index=True,
                                  return_inverse=True)
    else:
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    out = {k2: v[first] for k2, v in vals.items()}
    if pad_flag is not None:
        out["is_padding"] = pad_flag[first].astype(bool)
    out["inv"] = inv
    out["ref_base"] = refseq[positions - 1]
    return positions, out, stats
