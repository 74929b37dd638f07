#!/usr/bin/env python3
"""Bring-up check of pisces_tpu on one NVIDIA GPU.

Phases, in this one process:
  0. device: the card, JAX's devices, the native library and its sources.
  1. kernel parity at real widths: score_snv_loci and score_reference_tuples
     on a seeded grid of 2^20 rows (per-direction coverage 0..5,000),
     compared with the f64 host backend (ops/stats.py): integer outputs and
     strand-bias booleans exact, frequency within one float32 ulp. Prints
     compile seconds, warm per-call time and memory_analysis() per kernel.
  2. the main path end to end: a seeded deep-panel BAM (1,000x mean depth
     over 200 kb, 2M single-end 100 bp reads, 0.1% error floor, messy
     CIGARs, planted SNVs and indels at 1-8% VF) through the CLI entry
     (apps/pisces.main) with -backend jax and -backend numpy; the VCF bodies
     must be byte-equal and both device kernels must have scored rows at
     the default dispatch thresholds.

The last line of standard output is one JSON object; it says "ok": true
only when every phase passed on a GPU. Any failure exits non-zero.

Usage: python3 chip_smoke.py [--seed N] [--rehearse]
  --rehearse  every phase at a tiny size on the CPU, to check the script
              without a GPU; its last line says "ok": false.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke_work")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_name_and_power(rehearse: bool) -> str:
    """`name, power.limit` of the card as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        if rehearse:
            return "no GPU (rehearsal)"
        fail(f"nvidia-smi did not run: {e}")
    if r.returncode != 0 or not r.stdout.strip():
        if rehearse:
            return "no GPU (rehearsal)"
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def check_device(device, rehearse: bool = False) -> None:
    """Refuse any first device but a GPU (a CPU one only in rehearsal)."""
    if device.platform != "gpu" and not (rehearse and device.platform == "cpu"):
        fail(f"JAX's first device is {device.platform} ({device}), not a GPU")


def _timed_kernel(name, kernel, args, params, card, reps=10):
    """Compile `kernel` for `args`, then time warm calls; returns outputs."""
    import jax
    import numpy as np

    with jax.enable_x64(True):
        lowered = kernel.jitted.lower(*args, params)
        t0 = time.perf_counter()
        compiled = lowered.compile()
        compile_s = time.perf_counter() - t0
    out = kernel(*args, params)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = kernel(*args, params)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    rows = args[0].shape[0]
    print(f"phase 1: {name}: compile {compile_s:.2f} s; warm call median "
          f"{med * 1e3:.3f} ms (min {min(times) * 1e3:.3f} ms, {reps} calls) "
          f"= {rows / med:,.0f} rows/s | {card}", flush=True)
    print(f"phase 1: {name}: memory_analysis {compiled.memory_analysis()} "
          f"| {card}", flush=True)
    return {k: np.asarray(v) for k, v in out.items()}


def phase1(rows: int, seed: int, card: str) -> dict:
    import jax

    from pisces_tpu.ops import parity
    from pisces_tpu.ops.jax_scoring import (
        score_reference_tuples, score_snv_loci,
    )
    from pisces_tpu.ops.scoring_params import ScoringParams

    params = ScoringParams()
    grid = parity.make_grid(rows, seed, 5000)
    dev = {k: jax.device_put(v) for k, v in grid.items()}
    outputs = {
        "score_snv_loci": _timed_kernel(
            "score_snv_loci", score_snv_loci,
            (dev["sup"], dev["cov"], dev["ref"], dev["nc"], dev["total"]),
            params, card),
        "score_reference_tuples": _timed_kernel(
            "score_reference_tuples", score_reference_tuples,
            (dev["sup"], dev["cov"]), params, card),
    }
    report = parity.check_kernels(rows, seed, 5000, params, outputs=outputs)
    for kernel in ("score_snv_loci", "score_reference_tuples"):
        r = report[kernel]
        counts = {k: v["mismatches"] for k, v in r.items()
                  if isinstance(v, dict)}
        print(f"phase 1: {kernel} vs f64 host on {rows} rows: mismatches "
              f"{counts}, frequency max {r['frequency_max_ulp']} ulp",
              flush=True)
        for k, v in r.items():
            if isinstance(v, dict) and v["mismatches"]:
                print(f"phase 1:   {k} examples: {v['examples']}", flush=True)
    if not parity.passed(report):
        fail("phase 1: device kernels disagree with the f64 host backend")
    return report


def _vcf_body(path: str) -> bytes:
    with open(path, "rb") as f:
        return b"".join(line for line in f if not line.startswith(b"#"))


def _run_cli(bam: str, genome: str, out_dir: str, backend: str) -> dict:
    from pisces_tpu.apps.pisces import main as pisces_main
    from pisces_tpu.utils.metrics import metrics

    metrics.reset()
    metrics_path = os.path.join(out_dir, "metrics.json")
    t0 = time.perf_counter()
    rc = pisces_main(["-bam", bam, "-g", genome, "-o", out_dir,
                      "-gVCF", "true", "-backend", backend,
                      "-MetricsJson", metrics_path])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 2: the CLI with -backend {backend} exited {rc}")
    with open(metrics_path) as f:
        snap = json.load(f)
    snap["cli_wall_seconds"] = wall
    return snap


def phase2(n_reads: int, territory: int, seed: int, card: str,
           rehearse: bool) -> dict:
    import jax

    import bench
    from pisces_tpu.ops.jax_scoring import (
        score_reference_tuples, score_snv_loci,
    )

    shutil.rmtree(WORK, ignore_errors=True)
    read_len = 100
    depth = n_reads * read_len / territory
    print(f"phase 2: deep-panel input: {n_reads:,} single-end {read_len} bp "
          f"reads over {territory:,} bp = {depth:,.0f}x mean depth; reduced: "
          f"the territory is cut from the 0.5-2 Mb of a real panel to "
          f"{territory / 1e3:,.0f} kb", flush=True)
    t0 = time.perf_counter()
    bam, genome = bench.generate_wgs_workload(
        os.path.join(WORK, "input"), n_reads=n_reads, chrom_len=territory,
        read_len=read_len, base_error_rate=0.001,
        n_var_sites=territory // 700, n_indel_sites=territory // 2000,
        seed=seed, vf_range=(0.01, 0.08))
    print(f"phase 2: input generated in {time.perf_counter() - t0:.1f} s",
          flush=True)

    kernels = {"score_snv_loci": score_snv_loci,
               "score_reference_tuples": score_reference_tuples}
    before = {k: f.jitted._cache_size() for k, f in kernels.items()}
    runs = {}
    for backend in ("jax", "numpy"):
        out_dir = os.path.join(WORK, backend)
        runs[backend] = _run_cli(bam, genome, out_dir, backend)
    compiles = {k: f.jitted._cache_size() - before[k]
                for k, f in kernels.items()}

    jx = runs["jax"]
    for backend, snap in runs.items():
        stages = ", ".join(f"{k} {v['seconds']:.3f} s"
                           for k, v in snap["stages"].items())
        print(f"phase 2: -backend {backend}: CLI wall "
              f"{snap['cli_wall_seconds']:.2f} s; stages: {stages} | {card}",
              flush=True)
    counters = jx["counters"]
    device_rows = {k: int(counters.get(k, 0)) for k in
                   ("device_rows_snv_loci", "device_rows_reference_tuples")}
    peak = jax.devices()[0].memory_stats() or {}
    print(f"phase 2: rows scored on the device: {device_rows}; "
          f"compiles paid by the jax run: {compiles}; device peak memory "
          f"{peak.get('peak_bytes_in_use', 0) / 2**20:,.1f} MiB "
          f"(run's watermark {jx['device_peak_bytes'] / 2**20:,.1f} MiB) "
          f"| {card}", flush=True)

    body_jax = _vcf_body(os.path.join(WORK, "jax", "wgs.genome.vcf"))
    body_np = _vcf_body(os.path.join(WORK, "numpy", "wgs.genome.vcf"))
    n_lines = body_np.count(b"\n")
    if body_jax != body_np:
        a, b = body_jax.splitlines(), body_np.splitlines()
        diffs = [(x, y) for x, y in zip(a, b) if x != y][:5]
        fail(f"phase 2: VCF bodies differ ({len(a)} vs {len(b)} lines); "
             f"first differing lines (jax, numpy): {diffs}")
    print(f"phase 2: VCF bodies byte-equal, {n_lines:,} lines", flush=True)
    if min(device_rows.values()) <= 0:
        fail(f"phase 2: a device kernel scored no rows: {device_rows}")
    platform = jx["device"].get("platform")
    if platform != ("cpu" if rehearse else "gpu"):
        fail(f"phase 2: the jax run recorded platform {platform!r}")
    shutil.rmtree(WORK, ignore_errors=True)
    return {"device_rows": device_rows, "compiles": compiles,
            "vcf_lines": n_lines}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU; never reports ok")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "pisces_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)

    import jax

    from pisces_tpu.io import native
    from pisces_tpu.utils.device import configure_compile_cache

    cache = configure_compile_cache()
    t_start = time.perf_counter()
    card = card_name_and_power(args.rehearse)
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}; devices {jax.devices()}; compile cache "
          f"{cache}", flush=True)
    device = jax.devices()[0]
    check_device(device, args.rehearse)
    if native.get_lib() is None:
        fail("the native library libpisces_io.so could not be built")
    info = native.library_info()
    print(f"native library {info['path']} built from sources "
          f"sha256 {info['source_hash']}", flush=True)

    phase1(1 << 12 if args.rehearse else 1 << 20, args.seed, card)
    if args.rehearse:
        phase2(300_000, 30_000, args.seed, card, rehearse=True)
    else:
        phase2(2_000_000, 200_000, args.seed, card, rehearse=False)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s | {card}", flush=True)
    print(json.dumps({"ok": not args.rehearse,
                      "device": {"platform": device.platform,
                                 "kind": device.device_kind,
                                 "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
