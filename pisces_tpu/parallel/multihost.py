"""Multi-host execution (SURVEY §2.5 P4/P9 mapping).

The reference scales past one machine by spawning `Pisces -InsideSubProcess
-chrFilter chrN` children and merging per-chr VCF shards (Program.cs:46-48,
GenomeProcessor.CombinePerChromosomeFiles). The JAX analog: one JAX
process per host, joined via jax.distributed.initialize; chromosomes are
deterministically partitioned across hosts; each host writes atomic per-chr
shards to the shared output directory; host 0 merges when every shard
exists. Device collectives (psum/all_gather over the global mesh) remain
available for cross-host statistics (VQR signature counts, AdaptiveGT EM).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

from pisces_tpu.utils import logger


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     recoverable: bool = True,
                     heartbeat_timeout_s: int = 100,
                     shutdown_timeout_s: int = 20) -> tuple:
    """Join the jax.distributed job. Returns (process_id, num_processes).

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID when
    arguments are omitted; a no-op single-process setup otherwise.

    recoverable=True sets jax_enable_recoverability, so a surviving host
    keeps running when a peer dies (without it, the coordination service's
    error-polling thread FATALLY terminates every task on the first missed
    heartbeat — observed: 'Terminating process because the JAX distributed
    service detected fatal errors', client.h:80). The elastic work-steal
    path (wait_and_merge_shards recover=) requires survivors to outlive
    dead peers, the same way the reference's parent keeps running when an
    -InsideSubProcess child dies (CliTask.cs:55-90 reaps exit codes)."""
    import jax
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if not coordinator_address or not num_processes or num_processes <= 1:
        return 0, 1
    if recoverable:
        jax.config.update("jax_enable_recoverability", True)
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               heartbeat_timeout_seconds=heartbeat_timeout_s,
                               shutdown_timeout_seconds=shutdown_timeout_s)
    return jax.process_index(), jax.process_count()


def host_chromosome_assignment(chrom_lengths: Sequence[tuple],
                               n_hosts: int) -> List[List[str]]:
    """Longest-processing-time partition of chromosomes over hosts: sort by
    length descending, place each on the least-loaded host. Deterministic on
    every host (same inputs -> same plan), balanced by base count (the
    reference's per-chr job queue achieves balance dynamically; a static
    plan avoids cross-host coordination)."""
    order = sorted(chrom_lengths, key=lambda cl: (-cl[1], cl[0]))
    loads = [0] * n_hosts
    plan: List[List[str]] = [[] for _ in range(n_hosts)]
    for name, length in order:
        h = min(range(n_hosts), key=lambda i: (loads[i], i))
        plan[h].append(name)
        loads[h] += length
    return plan


def wait_and_merge_shards(final_vcf: str, shard_of: Dict[str, str],
                          chrom_order: Sequence[str],
                          timeout_s: float = 24 * 3600.0,
                          poll_s: float = 2.0,
                          recover=None,
                          stall_s: float = 600.0) -> str:
    """Host 0's merge barrier: wait until every chromosome shard exists
    (shards are written atomically via tmp+rename, so existence == done),
    then concatenate data lines after the first shard's header in genome
    order. The filesystem is the coordination channel, exactly like the
    reference's CombinePerChromosomeFiles (GenomeProcessor.cs:156-186).

    Elastic recovery: when `recover` is given and NO new shard appears for
    `stall_s`, host 0 assumes the owning host died and calls the missing
    chromosomes itself (work stealing; first atomic rename wins, so a
    slow-but-alive host racing the recovery is harmless)."""
    deadline = time.monotonic() + timeout_s
    missing = [c for c in chrom_order if not os.path.exists(shard_of[c])]
    last_progress = time.monotonic()
    n_missing = len(missing)
    while missing:
        if time.monotonic() > deadline:
            raise TimeoutError(f"shards never appeared: {missing}")
        if (recover is not None
                and time.monotonic() - last_progress > stall_s):
            logger.log(f"no shard progress for {stall_s:.0f}s; host 0 "
                       f"recovering {len(missing)} orphaned chromosome(s): "
                       + ",".join(missing), "WARNING")
            for c in list(missing):
                if not os.path.exists(shard_of[c]):
                    recover(c)
        time.sleep(poll_s)
        missing = [c for c in chrom_order if not os.path.exists(shard_of[c])]
        if len(missing) != n_missing:
            n_missing = len(missing)
            last_progress = time.monotonic()
    with open(final_vcf, "w", newline="\n") as out:
        wrote_header = False
        for c in chrom_order:
            with open(shard_of[c]) as f:
                for line in f:
                    if line.startswith("#"):
                        if not wrote_header:
                            out.write(line)
                    else:
                        out.write(line)
            wrote_header = True
    for c in chrom_order:
        os.unlink(shard_of[c])
    return final_vcf


def process_bam_multihost(options, bam_path: str, genome_dir: str,
                          use_device: bool = False,
                          coordinator_address: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None,
                          recover_stall_s: float = 600.0,
                          delay_per_chr: float = 0.0) -> Optional[str]:
    """Run this host's share of chromosomes; host 0 merges and returns the
    final VCF path, other hosts return None."""
    from pisces_tpu.apps.pisces import process_bam
    from pisces_tpu.io.fasta import Genome

    pid, n_hosts = init_distributed(coordinator_address, num_processes,
                                    process_id)
    genome = Genome(genome_dir)
    chrom_lengths = genome.chromosome_lengths
    plan = host_chromosome_assignment(chrom_lengths, n_hosts)
    mine = plan[pid]
    logger.log(f"host {pid}/{n_hosts}: assigned {len(mine)} chromosomes "
               f"({','.join(mine[:8])}{'...' if len(mine) > 8 else ''})")

    out_dir = options.output_directory or os.path.dirname(bam_path)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.basename(bam_path)
    stem = stem[:-4] if stem.endswith(".bam") else stem
    gvcf = options.vcf_writing_parameters.output_gvcf_file
    final_vcf = os.path.join(out_dir,
                             stem + (".genome.vcf" if gvcf else ".vcf"))
    shard_of = {c: os.path.join(out_dir, f"{stem}.vcf_{c}")
                for c, _l in chrom_lengths}

    for k, chrom in enumerate(mine):
        if delay_per_chr and k > 0:
            time.sleep(delay_per_chr)  # test hook (see main --delay-per-chr)
        tmp = shard_of[chrom] + f".tmp{pid}"
        options.chromosome_filter = chrom
        process_bam(options, bam_path, genome, out_vcf=tmp,
                    use_device=use_device)
        os.replace(tmp, shard_of[chrom])

    if pid != 0:
        return None

    def _recover(chrom: str) -> None:
        tmp = shard_of[chrom] + ".tmp0r"
        options.chromosome_filter = chrom
        process_bam(options, bam_path, genome, out_vcf=tmp,
                    use_device=use_device)
        if not os.path.exists(shard_of[chrom]):  # first rename wins
            os.replace(tmp, shard_of[chrom])
        else:
            os.unlink(tmp)

    return wait_and_merge_shards(final_vcf, shard_of,
                                 [c for c, _l in chrom_lengths],
                                 recover=_recover, stall_s=recover_stall_s)


# ---------------------------------------------------------------------------
# real multi-process entry: one OS process per "host", joined through the
# jax.distributed coordinator (the multi-host shape, runnable on one box
# with the CPU backend). The reference analog actually spawns its children too
# (Pisces Program.cs:46-48 -InsideSubProcess fan-out).
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    """Worker entry: join the coordinator, call this host's chromosomes,
    host 0 merges. `python -m pisces_tpu.parallel.multihost -bam .. -g ..
    -o .. --coordinator host:port --nprocs N --pid I`."""
    import argparse

    import jax

    from pisces_tpu.options import PiscesApplicationOptions

    p = argparse.ArgumentParser(prog="pisces_tpu.parallel.multihost")
    p.add_argument("-bam", required=True)
    p.add_argument("-g", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--nprocs", type=int, required=True)
    p.add_argument("--pid", type=int, required=True)
    p.add_argument("--gvcf", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (workers on one box must not "
                        "each open the same device)")
    p.add_argument("--stall", type=float, default=600.0,
                   help="host 0 work-steals a dead host's chromosomes "
                        "after this many seconds without shard progress")
    p.add_argument("--delay-per-chr", type=float, default=0.0,
                   help="test hook: sleep before each chromosome so a "
                        "mid-run SIGKILL lands deterministically")
    a = p.parse_args(argv)
    if a.cpu:
        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            pass
    o = PiscesApplicationOptions()
    o.output_directory = a.o
    o.vcf_writing_parameters.output_gvcf_file = a.gvcf
    merged = process_bam_multihost(
        o, a.bam, a.g, use_device=False, coordinator_address=a.coordinator,
        num_processes=a.nprocs, process_id=a.pid,
        recover_stall_s=a.stall, delay_per_chr=a.delay_per_chr)
    import jax as _j
    print(f"multihost worker pid={a.pid} process_count={_j.process_count()} "
          f"merged={merged or '-'}", flush=True)
    return 0


def run_local_multihost(bam_path: str, genome_dir: str, out_dir: str,
                        n_procs: int = 2, gvcf: bool = True,
                        timeout_s: float = 600.0,
                        kill_worker: Optional[int] = None,
                        recover_stall_s: float = 600.0,
                        delay_per_chr: float = 0.0) -> str:
    """Spawn n_procs coordinator-joined worker processes on this box (CPU
    backend) and return the merged VCF path. Used by tests and the bench's
    multihost stage.

    kill_worker: SIGKILL that worker right after it renames its FIRST
    shard (a real mid-run process death — the reference's children can die
    the same way, CliTask.cs:55-90 checks their exit codes); host 0 must
    work-steal the dead worker's remaining chromosomes after
    recover_stall_s without shard progress and still produce the complete
    merged VCF."""
    import signal
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    pp = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = os.pathsep.join([repo] + ([pp] if pp else []))
    procs = []
    for i in range(n_procs):
        cmd = [sys.executable, "-m", "pisces_tpu.parallel.multihost",
               "-bam", bam_path, "-g", genome_dir, "-o", out_dir,
               "--coordinator", coord, "--nprocs", str(n_procs),
               "--pid", str(i), "--cpu", "--stall", str(recover_stall_s)]
        if delay_per_chr:
            cmd += ["--delay-per-chr", str(delay_per_chr)]
        if gvcf:
            cmd.append("--gvcf")
        procs.append(subprocess.Popen(cmd, env=env, cwd=repo,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))

    if kill_worker is not None:
        # deterministic mid-run death: wait for the victim's first shard
        # (the LPT plan is deterministic, so its chromosome set is known),
        # then SIGKILL it while its remaining chromosomes are unwritten
        from pisces_tpu.io.fasta import Genome
        plan = host_chromosome_assignment(
            Genome(genome_dir).chromosome_lengths, n_procs)
        victim_chroms = plan[kill_worker]
        assert len(victim_chroms) >= 2, "kill test needs >=2 chroms/worker"
        stem0 = os.path.basename(bam_path)
        stem0 = stem0[:-4] if stem0.endswith(".bam") else stem0
        first_shard = os.path.join(out_dir,
                                   f"{stem0}.vcf_{victim_chroms[0]}")
        deadline = time.monotonic() + timeout_s / 2
        while (not os.path.exists(first_shard)
               and procs[kill_worker].poll() is None):
            if time.monotonic() > deadline:
                raise RuntimeError("victim never wrote its first shard")
            time.sleep(0.05)
        procs[kill_worker].send_signal(signal.SIGKILL)

    outs = []
    for i, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=timeout_s)
        outs.append(out)
        if i == kill_worker:
            if pr.returncode == 0:
                raise RuntimeError("victim finished before the kill landed; "
                                   "increase delay_per_chr")
            continue
        if pr.returncode != 0:
            raise RuntimeError(
                f"multihost worker {i} rc={pr.returncode}:\n{out[-2000:]}")
        if f"process_count={n_procs}" not in out:
            raise RuntimeError(
                f"worker {i} did not join the {n_procs}-process "
                f"coordinator:\n{out[-2000:]}")
    stem = os.path.basename(bam_path)
    stem = stem[:-4] if stem.endswith(".bam") else stem
    merged = os.path.join(out_dir,
                          stem + (".genome.vcf" if gvcf else ".vcf"))
    if not os.path.exists(merged):
        raise RuntimeError(f"merged VCF missing; worker logs:\n"
                           + "\n".join(o[-1000:] for o in outs))
    return merged


if __name__ == "__main__":
    raise SystemExit(main())
