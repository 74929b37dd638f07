"""One-off measurement: device-side pileup build vs the C++ host pileup.

SURVEY §7 sketch item 2 proposed building the [block, 6, 3] count tensor on
device with a scatter-add/segment-sum (the RegionStateManager.cs:118-220
AddAlleleCounts accumulation). The production build instead runs the pileup
in host C++ (io/_native/pisces_io.cpp bam_pileup_mm) and ships counts up.
This script measures both at WES scale so that the decision rests on a
number measured on the device it is made for.

Measured quantities, one WES-shaped chromosome (600kb, 160k reads, 16M
base events):
  1. C++ host pileup: wall clock of bam_pileup_mm over the decoded batch
     (the production path: decode -> fused pileup -> dense tensors).
  2. XLA device scatter-add: zeros([L,6,3]).at[pos, allele, dir].add(1),
     K-chained inside one jit (accumulator->input dependency), one scalar
     fetched, so the time is the device's and not a per-step host sync.
  3. Host->device transfer of the event arrays themselves (the cost the
     device path must pay before it can scatter).

Usage: python scripts/measure_device_pileup.py [--events N] [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def measure_host_cpp(tmp: str):
    """C++ pileup over a real decoded WES-shaped batch."""
    from bench import _write_synthetic_workload
    from pisces_tpu.io.native import open_bam, native_pileup

    bam, gdir = _write_synthetic_workload(tmp, 1, 600_000, 160_000)
    reader = open_bam(bam)
    rid = reader.header.ref_index("chr1")
    batch = reader.fetch(ref_id=rid)
    keep = np.ones(batch.n, dtype=bool)
    # warm (first call pays decode caching)
    native_pileup(reader, keep, 20, 5, 1000)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        counts, _mm = native_pileup(reader, keep, 20, 5, 1000)
        best = min(best, time.perf_counter() - t0)
    n_events = int(batch.n) * 100  # 100bp reads
    return n_events, best


def measure_device_scatter(n_events: int, L: int = 600_000, iters: int = 8):
    """XLA scatter-add building [L,6,3] from event arrays, K-chained."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    # WES-shaped: events are consecutive positions per read
    n_reads = n_events // 100
    starts = np.sort(rng.integers(0, L - 100, n_reads))
    pos = (starts[:, None] + np.arange(100)[None, :]).reshape(-1)
    pos = pos.astype(np.int32)
    allele = rng.integers(0, 6, n_events).astype(np.int8)
    direction = rng.integers(0, 3, n_events).astype(np.int8)

    @jax.jit
    def run(p, a, d):
        def body(i, acc):
            counts = jnp.zeros((L, 6, 3), jnp.int32)
            counts = counts.at[p + (acc & 1), a.astype(jnp.int32),
                               d.astype(jnp.int32)].add(1)
            return counts.sum(dtype=jnp.int32)
        return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

    t0 = time.perf_counter()
    p_d = jax.device_put(pos)
    a_d = jax.device_put(allele)
    d_d = jax.device_put(direction)
    # force the transfer to complete by touching one scalar of each
    _ = (int(p_d[0]), int(a_d[0]), int(d_d[0]))
    transfer_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    v = int(run(p_d, a_d, d_d))  # compile + warm
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v = int(run(p_d, a_d, d_d))
    dt = time.perf_counter() - t0
    assert v != 0
    return dt / iters, transfer_s, compile_s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--iters", type=int, default=8)
    a = ap.parse_args()
    if a.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    n_events, host_s = measure_host_cpp("/tmp/pisces_device_pileup")
    print(f"host C++ pileup:   {n_events:,} events in {host_s * 1e3:.1f} ms "
          f"= {n_events / host_s / 1e6:,.0f} M events/s", flush=True)

    dev_s, transfer_s, compile_s = measure_device_scatter(
        n_events, iters=a.iters)
    import jax
    backend = jax.devices()[0].platform
    print(f"device scatter ({backend}): {n_events:,} events in "
          f"{dev_s * 1e3:.1f} ms/iter = {n_events / dev_s / 1e6:,.1f} "
          f"M events/s steady-state (compile {compile_s:.0f}s)", flush=True)
    print(f"h2d event transfer: {transfer_s:.2f}s for "
          f"{(n_events * 6) / 1e6:.0f} MB "
          f"({(n_events * 6) / transfer_s / 1e6:.1f} MB/s)", flush=True)
    total_dev = dev_s + transfer_s
    winner = "host C++" if host_s < total_dev else "device scatter"
    print(f"decision input: host {host_s * 1e3:.0f} ms vs device "
          f"{total_dev * 1e3:.0f} ms (scatter {dev_s * 1e3:.0f} + transfer "
          f"{transfer_s * 1e3:.0f}) per WES block sweep -> {winner}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
