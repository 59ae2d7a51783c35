"""Sharded-pipeline scaling report (manual).

Runs the full sharded syncmer collection (extract -> hash-range
all_to_all -> device accumulate -> per-shard sort -> DB build) at
several mesh sizes and reports wall clock, per-shard occupancy balance,
and output equality against the single-device path.

On this host the mesh is XLA_FLAGS=--xla_force_host_platform_device_count
virtual CPU devices sharing 4 cores, so wall-clock does NOT scale --
the report demonstrates functional scaling (balance, correctness) and
records the collective layout; device-level scaling needs real
multi-GPU hardware (chip_smoke.py --cards 4 runs the sharded path).

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python tests/bench_scaling.py [--mbp 20]
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=int, default=20)
    ap.add_argument("--k", type=int, default=251)
    ap.add_argument("--s", type=int, default=17)
    args = ap.parse_args()

    import jax

    import oatk_tpu  # noqa: F401
    from genome_sim import random_genome, sample_reads, write_reads
    from oatk_tpu.asm.pipeline import load_reads
    from oatk_tpu.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu.dist.sharding import make_mesh
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    n_dev = len(jax.devices())
    rng = np.random.default_rng(9)
    genome = random_genome(rng, 250_000)
    reads = sample_reads(rng, genome, coverage=args.mbp * 1e6 / 250_000,
                         read_len=15_000)
    td = tempfile.mkdtemp()
    fa = os.path.join(td, "reads.fa")
    write_reads(fa, reads)
    total = sum(len(r) for r in reads)
    print(f"dataset: {total/1e6:.1f} Mbp, {len(reads)} reads; "
          f"{n_dev} devices visible", flush=True)

    t0 = time.time()
    db0 = load_reads([fa], args.k, args.s, 0, True)
    scm0 = collect_syncmer_db(db0)
    t_single = time.time() - t0
    print(f"single-device: {t_single:.2f} s, {scm0.n} syncmers", flush=True)

    for d in (2, 4, 8):
        if d > n_dev:
            continue
        mesh = make_mesh(d)
        t0 = time.time()
        db, coll = load_and_extract_sharded([fa], args.k, args.s, mesh)
        occ = np.asarray(jax.device_get(coll._state[2]))  # per-shard fill
        scm = coll.build(db)
        dt = time.time() - t0
        same = (
            scm.n == scm0.n
            and np.array_equal(scm.h, scm0.h)
            and np.array_equal(scm.cov, scm0.cov)
        )
        balance = occ.min() / max(1, occ.max())
        print(
            f"shards={d}: {dt:.2f} s | per-shard occurrences "
            f"{occ.tolist()} (balance {balance:.2f}) | "
            f"DB identical to single-device: {same}",
            flush=True,
        )
        assert same


if __name__ == "__main__":
    main()
