#!/usr/bin/env python
"""Focused load_extract instrumentation harness.

Runs ONLY the loader + device counting on the 110 Mbp bench dataset,
N warm repetitions, and prints per-run sub-splits:

- wall-view phases from the main thread (read_bytes, cuts, parse_wait,
  dispatch, fetch, assemble, pool_shutdown);
- worker-side parse/pack CPU sums (overlapped with the wall phases);
- collect_db (device finalize sort + id fetch + host DB assembly).

Usage: python tools/bench_load_split.py [n_runs] [dataset.fa]
(defaults: 5 runs, bench_data/reads_110.fa -- generate it by running
bench.py once).
"""
from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    n_runs = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    data = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        REPO, "bench_data", "reads_110.fa"
    )
    if not os.path.exists(data):
        sys.exit(f"dataset {data} missing; run bench.py once to generate it")

    import oatk_tpu  # noqa: F401
    from oatk_tpu.asm.reads import load_and_extract
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    total = 0
    with open(data) as f:
        for line in f:
            if not line.startswith(">"):
                total += len(line) - 1

    # warm the shapes once (cache hit when bench.py ran before)
    t0 = time.time()
    db = load_and_extract([data], 1001, 31, device_count=True)
    if db is None:
        sys.exit("fused loader unavailable (needs the native library)")
    collect_syncmer_db(db)
    print(f"warm run: {time.time() - t0:.2f} s", flush=True)

    for i in range(n_runs):
        t0 = time.time()
        db = load_and_extract([data], 1001, 31, device_count=True)
        t_load = time.time() - t0
        scm = collect_syncmer_db(db)
        t_tot = time.time() - t0
        lt = {k: round(v, 3) for k, v in (db.load_timings or {}).items()}
        dc = getattr(db, "_devcount_stats", None) or getattr(db, "_devcount", None)
        print(json.dumps({
            "run": i,
            "load_s": round(t_load, 3),
            "collect_s": round(t_tot - t_load, 3),
            "mbps": round(total / 1e6 / t_tot, 1),
            "split": lt,
            "devcount": (
                {"cap": dc.cap, "appends": dc.n_append, "grows": dc.n_grow}
                if dc is not None else None
            ),
            "n_scm": scm.n if scm else 0,
        }), flush=True)


if __name__ == "__main__":
    main()
