#!/usr/bin/env python
"""Benchmark: full syncasm pipeline + extraction throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
naming the device (platform, kind, count) and the card's name and power
limit.  Refuses to run (exit 1) when JAX finds no GPU.

Headline metric = END-TO-END syncasm throughput (Mbp/s) on a 110 Mbp
organelle-realistic dataset (mito 370 kb with a 12 kb direct repeat,
quadripartite pltd 147 kb, 3x nuclear background -- the same family as
tests/validate_large.py), oatk defaults k=1001/s=31, EC ON, 3 unzip
rounds, c=30, vs the reference `syncasm -k 1001 -c 30 -t 4` on the
same reads.  Auxiliary fields keep the 30 Mbp full-pipeline and
extraction+counting numbers plus the device-kernel spot-check result.

Protocol: the jit cache is warmed on the exact shapes first
(compile-once stream-many is the production regime), then best-of-N.
Before timing, a small batch runs through the device kernel and is
asserted against the host oracle, so kernel regressions surface as a
failed bench instead of a wrong number.  After the timed runs the
output GFA is byte-compared against the reference binary's when it is
available.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

WORK = os.path.join(REPO, "bench_data")
DATA = os.path.join(WORK, "reads.fa")
DATA110 = os.path.join(WORK, "reads_110.fa")
REFBIN = "/root/refbin/syncasm"
K, S = 1001, 31
N_RUNS = int(os.environ.get("OATK_BENCH_RUNS", "5"))


def ensure_dataset() -> int:
    if os.path.exists(DATA):
        total = 0
        with open(DATA) as f:
            for line in f:
                if not line.startswith(">"):
                    total += len(line) - 1
        return total
    from genome_sim import random_genome, sample_reads

    rng = np.random.default_rng(2026)
    genome = random_genome(rng, 300_000)
    reads = sample_reads(rng, genome, coverage=100, read_len=15_000)
    with open(DATA, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return sum(len(r) for r in reads)


def ensure_dataset_110() -> int:
    if os.path.exists(DATA110):
        total = 0
        with open(DATA110) as f:
            for line in f:
                if not line.startswith(">"):
                    total += len(line) - 1
        return total
    from genome_sim import random_genome, revcomp, sample_reads

    rng = np.random.default_rng(20260818)
    core_a = random_genome(rng, 160_000)
    rep = random_genome(rng, 12_000)
    core_b = random_genome(rng, 186_000)
    mito = core_a + rep + core_b + rep
    lsc = random_genome(rng, 86_000)
    ir = random_genome(rng, 25_000)
    ssc = random_genome(rng, 18_000)
    pltd = lsc + ir + ssc + revcomp(ir)
    reads = []
    reads += sample_reads(rng, mito, coverage=120, read_len=15_000,
                          err_rate=0.001, hp_frac=0.85)
    reads += sample_reads(rng, pltd, coverage=250, read_len=15_000,
                          err_rate=0.001, hp_frac=0.85)
    organelle = sum(len(r) for r in reads)
    need = 110_000_000 - organelle
    for _ in range(8):
        g = random_genome(rng, int(need / 3 / 8))
        reads += sample_reads(rng, g, coverage=3, read_len=15_000,
                              err_rate=0.001, circular=False, hp_frac=0.85)
    rng.shuffle(reads)
    with open(DATA110, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return sum(len(r) for r in reads)


def measure_reference_110(total_bases: int) -> float:
    args = [REFBIN, "-k", str(K), "-s", str(S), "-t", "4", "-c", "30",
            "--unzip-round", "3", "-o", os.path.join(WORK, "ref_110")]
    best = None
    for _ in range(3):
        t0 = time.time()
        subprocess.run(args + [DATA110], capture_output=True)
        best = min(best or 1e9, time.time() - t0)
    return total_bases / 1e6 / best


def measure_reference_110_t8(total_bases: int) -> float:
    """Amdahl-extrapolated 8-thread reference throughput at 110 Mbp.

    The reference README prescribes -t 8, so the honest target is the
    t=8 EQUIVALENT:
    fit wall(t) = serial + par/t on t=1,2,4 (best-of-2 each) and
    evaluate at t=8.  Optimistic for the reference (assumes perfect
    scaling to 8 real cores), which keeps the comparison conservative
    for us."""
    walls = {}
    for t in (1, 2, 4):
        args = [REFBIN, "-k", str(K), "-s", str(S), "-t", str(t), "-c", "30",
                "--unzip-round", "3", "-o", os.path.join(WORK, f"ref_t{t}")]
        best = None
        for _ in range(2):
            t0 = time.time()
            subprocess.run(args + [DATA110], capture_output=True)
            best = min(best or 1e9, time.time() - t0)
        walls[t] = best
    # least squares for wall = s + p/t over (1, 2, 4)
    import numpy as _np

    A = _np.array([[1.0, 1.0 / t] for t in walls])
    y = _np.array([walls[t] for t in walls])
    s_, p_ = _np.linalg.lstsq(A, y, rcond=None)[0]
    t8 = max(s_ + p_ / 8.0, walls[4] * 0.5)  # sanity floor
    return total_bases / 1e6 / t8


def measure_reference(total_bases: int, full: bool) -> float:
    args = [REFBIN, "-k", str(K), "-s", str(S), "-t", "4",
            "-o", os.path.join(WORK, "ref_full" if full else "ref")]
    if full:
        args += ["-c", "30", "--unzip-round", "3"]
    else:
        args += ["-c", "1000000", "--no-read-ec", "--unzip-round", "0"]
    best = None
    for _ in range(3):
        t0 = time.time()
        subprocess.run(args + [DATA], capture_output=True)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return total_bases / 1e6 / best


def kernel_spot_check() -> str:
    """Small-batch device-kernel == host-oracle assertion (pre-timing)."""
    from oatk_tpu.asm.reads import extract_all_syncmers
    from oatk_tpu.io.fastx import SeqRecord
    from genome_sim import random_genome

    rng = np.random.default_rng(7)
    recs = []
    for i in range(4):
        seq = random_genome(rng, 4000)
        recs.append(SeqRecord(sid=i, name=f"c{i}", seq=np.frombuffer(seq.encode(), np.uint8)))
    dev = extract_all_syncmers(recs, K, S, use_device=True)
    orc = extract_all_syncmers(recs, K, S, use_device=False)
    for a, b in zip(dev.reads, orc.reads):
        assert np.array_equal(a.m_pos, b.m_pos), "kernel positions != oracle"
        assert np.array_equal(a.k_mer, b.k_mer), "kernel hashes != oracle"
        assert np.array_equal(a.s_mer, b.s_mer), "kernel smers != oracle"
    return "ok"


def gpu_or_exit():
    """(device dict, card string) for the result line; exits 1 when JAX
    finds no GPU, so nothing is ever reported for another backend."""
    import jax

    import oatk_tpu  # noqa: F401  (x64 and the compile cache, before first use)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {devs[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    return dev, card


def ensure_refbin():
    """/root/refbin lives outside the repo and is wiped between rounds;
    rebuild the parity/baseline oracles from /root/reference on demand."""
    if os.path.exists(REFBIN):
        return
    script = os.path.join(REPO, "tools", "build_refbin.sh")
    try:
        subprocess.run(["bash", script], check=True, capture_output=True,
                       timeout=600)
    except Exception:
        pass  # bench degrades to vs_baseline=None rather than crashing


def main():
    device, card = gpu_or_exit()
    os.makedirs(WORK, exist_ok=True)
    ensure_refbin()
    total_bases = ensure_dataset()

    baseline_path = os.path.join(REPO, "BASELINE.json")
    with open(baseline_path) as f:
        baseline = json.load(f)
    pub = baseline.setdefault("published", {})
    changed = False
    if not pub.get("ref_extract_count_mbps") and os.path.exists(REFBIN):
        pub["ref_extract_count_mbps"] = round(measure_reference(total_bases, False), 2)
        changed = True
    if not pub.get("ref_full_pipeline_mbps") and os.path.exists(REFBIN):
        pub["ref_full_pipeline_mbps"] = round(measure_reference(total_bases, True), 2)
        changed = True
    elif os.path.exists(REFBIN) and not os.path.exists(os.path.join(WORK, "ref_full.utg.final.gfa")):
        measure_reference(total_bases, True)  # regenerate parity oracle files
    total_110 = ensure_dataset_110()
    if not pub.get("ref_full_110_mbps") and os.path.exists(REFBIN):
        pub["ref_full_110_mbps"] = round(measure_reference_110(total_110), 2)
        changed = True
    elif os.path.exists(REFBIN) and not os.path.exists(
        os.path.join(WORK, "ref_110.utg.final.gfa")
    ):
        measure_reference_110(total_110)  # regenerate parity oracle files
    if not pub.get("ref_full_110_t8_mbps_est") and os.path.exists(REFBIN):
        pub["ref_full_110_t8_mbps_est"] = round(
            measure_reference_110_t8(total_110), 2
        )
        changed = True
    if changed:
        with open(baseline_path, "w") as f:
            json.dump(baseline, f, indent=2)
    ref_extract = pub.get("ref_extract_count_mbps")
    ref_full = pub.get("ref_full_pipeline_mbps")
    ref_110 = pub.get("ref_full_110_mbps")
    ref_110_t8 = pub.get("ref_full_110_t8_mbps_est")

    import oatk_tpu  # noqa: F401
    from oatk_tpu.asm.pipeline import load_reads, syncasm
    from oatk_tpu.asm.reads import load_and_extract
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    check = kernel_spot_check()

    def spread(times, base):
        """Variance fields for one metric: the best-of scalar alone
        can't distinguish progress from noise.  All values in Mbp/s over
        `base` bases."""
        ts = sorted(times)
        return {
            "best": round(base / 1e6 / ts[0], 2),
            "median": round(base / 1e6 / ts[len(ts) // 2], 2),
            "min": round(base / 1e6 / ts[-1], 2),
            "n": len(ts),
        }

    # ---- extraction + counting (round-1 headline, auxiliary now) ----
    def best_of(fn, n_min, n_max, patience=3):
        """(best, all_times) over adaptive repeats: keep running (up to
        n_max) until the best stops improving for `patience`
        consecutive runs."""
        best, since, times = None, 0, []
        for i in range(n_max):
            t0 = time.time()
            fn()
            dt = time.time() - t0
            times.append(dt)
            if best is None or dt < best * 0.98:
                best, since = min(best or dt, dt), 0
            else:
                since += 1
            if i + 1 >= n_min and since >= patience:
                break
        return best, times

    # warm jit cache on the exact shapes (incl. the device-counting
    # finalize sort consumed by collect_syncmer_db) -- and the host-sort
    # counting path used by the same-session A/B below
    collect_syncmer_db(load_and_extract([DATA], K, S, device_count=True))
    collect_syncmer_db(load_and_extract([DATA], K, S, device_count=False))

    def run_extract():
        # A/B leg: device-resident counting (the production default;
        # explicit here so the A/B stays meaningful under OATK_TPU_COUNT)
        read_db = load_and_extract([DATA], K, S, device_count=True)
        scm_db = collect_syncmer_db(read_db)
        assert scm_db is not None and scm_db.n > 0

    def run_extract_hostsort():
        # A/B leg: identical loader, counting via the host radix sort
        # instead of the device finalize sort -- back-to-back in ONE
        # process so the comparison shares the card and the host
        read_db = load_and_extract([DATA], K, S, device_count=False)
        scm_db = collect_syncmer_db(read_db)
        assert scm_db is not None and scm_db.n > 0

    best_x, times_x = best_of(run_extract, N_RUNS, 2 * N_RUNS + 2)
    best_xh, times_xh = best_of(run_extract_hostsort, N_RUNS, 2 * N_RUNS + 2)
    extract_mbps = total_bases / 1e6 / best_x

    # ---- full pipeline (EC on, 3 unzip rounds) ----
    def run_full():
        syncasm([DATA], k=K, s=S, min_k_cov=30, do_ec=True, do_unzip=3,
                out=os.path.join(WORK, "mine"))

    best_f, times_f = best_of(run_full, N_RUNS, 2 * N_RUNS + 2)
    full_mbps = total_bases / 1e6 / best_f

    # ---- at-scale full pipeline (110 Mbp, the headline) ----
    shares = {}
    load_split = {}

    def run_full_110():
        res = syncasm([DATA110], k=K, s=S, min_k_cov=30, do_ec=True, do_unzip=3,
                      out=os.path.join(WORK, "mine_110"))
        tm = res.timings or {}
        load = tm.get("load", 0.0)
        collect = tm.get("collect_db", 0.0)
        rest = sum(v for k_, v in tm.items() if k_ not in ("load", "collect_db"))
        tot = load + collect + rest
        if tot and (not shares or tot < shares.get("total_s", 1e9)):
            shares.update(
                load_extract_s=round(load, 3),
                collect_db_s=round(collect, 3),
                downstream_host_s=round(rest, 3),
                total_s=round(tot, 3),
            )
            # loader sub-split of the winning run: main-thread wall phases + worker-side parse/pack CPU sums
            lt = getattr(res.read_db, "load_timings", None) or {}
            load_split.clear()
            load_split.update({k_: round(v, 3) for k_, v in lt.items()})

    best_110, times_110 = best_of(run_full_110, max(3, N_RUNS - 2), N_RUNS + 3)
    full_110_mbps = total_110 / 1e6 / best_110

    parity = "unchecked"
    ref_gfa = os.path.join(WORK, "ref_full.utg.final.gfa")
    if os.path.exists(ref_gfa):
        a = open(ref_gfa, "rb").read()
        b = open(os.path.join(WORK, "mine.utg.final.gfa"), "rb").read()
        parity = "ok" if a == b else "MISMATCH"
        assert parity == "ok", "bench output differs from reference GFA"
    ref_gfa_110 = os.path.join(WORK, "ref_110.utg.final.gfa")
    if os.path.exists(ref_gfa_110):
        a = open(ref_gfa_110, "rb").read()
        b = open(os.path.join(WORK, "mine_110.utg.final.gfa"), "rb").read()
        assert a == b, "110 Mbp bench output differs from reference GFA"
        parity = "ok" if parity == "ok" else parity

    # same-process A/B: both counting paths measured back-to-back
    xh_mbps = total_bases / 1e6 / best_xh
    delta = (extract_mbps - xh_mbps) / xh_mbps
    ab_note = (
        f"devcount {extract_mbps:.1f} vs hostsort {xh_mbps:.1f} Mbp/s "
        f"same process ({delta:+.1%})"
    )

    print(
        json.dumps(
            {
                "metric": "syncasm_full_pipeline_throughput_110mbp",
                "value": round(full_110_mbps, 2),
                "unit": "Mbp/s",
                "vs_baseline": (
                    round(full_110_mbps / ref_110, 3) if ref_110 else None
                ),
                "vs_baseline_t8": (
                    round(full_110_mbps / ref_110_t8, 3) if ref_110_t8 else None
                ),
                "device": device,
                "card": card,
                "counting_default": (
                    "auto: host <60MB (30 Mbp leg), device >=60MB (110 Mbp leg)"
                ),
                "full_110mbp_spread": spread(times_110, total_110),
                "full_30mbp_mbps": round(full_mbps, 2),
                "full_30mbp_vs_baseline": (
                    round(full_mbps / ref_full, 3) if ref_full else None
                ),
                "full_30mbp_spread": spread(times_f, total_bases),
                "extract_count_mbps": round(extract_mbps, 2),
                "extract_vs_baseline": (
                    round(extract_mbps / ref_extract, 3) if ref_extract else None
                ),
                "extract_spread": spread(times_x, total_bases),
                "extract_hostsort_mbps": round(xh_mbps, 2),
                "extract_hostsort_spread": spread(times_xh, total_bases),
                "counting_ab_attribution": ab_note,
                "kernel_check": check,
                "gfa_parity": parity,
                "stage_shares_110mbp": shares,
                "load_split_110mbp": load_split,
                "baseline_threads": 4,
                "baseline_note": (
                    "vs_baseline = measured -t 4 reference (this host has 4 "
                    "cores); vs_baseline_t8 = Amdahl-extrapolated -t 8 "
                    "equivalent (README-prescribed config), fitted from "
                    "t=1/2/4 walls"
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
