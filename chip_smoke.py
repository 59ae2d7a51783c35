#!/usr/bin/env python
"""Smoke test of the assembler's main path on one NVIDIA GPU (or of the
sharded path on four).

Phases; any failure exits non-zero, and the last stdout line is the JSON
result only when every phase passed:

0. Device check: card name and power limit (nvidia-smi), JAX versions
   and devices.  Refuses to run without a GPU.
1. Compile the main-path extractor at k=1001/s=31 for every chunk shape
   the loader cuts from the phase-3 sample, and the device-counting
   append/finalize programs; prints compile seconds and memory analysis.
2. Selection against the sequential oracle on >=200 HiFi-length reads
   with homopolymers and N runs, through the fused loader: exact.
3. The syncasm and pathfinder CLIs in-process on the plant-like sample
   of tests/validate_large.py (--mbp, default 1000; generated before
   phase 1, whose shapes come from it); asserts that the
   fused loader ran, that device counting attached and that the mito
   and plastid unitigs are found, and prints the stage timings.
4. The same CLIs on a 40 Mbp sample, on the GPU in-process with device
   counting forced (the sample is below the size where it starts on
   its own) and on the CPU backend with host counting in a child
   process that never opens the card: every output file byte-identical.

--cards 4 runs phase 0 and then only the sharded path: syncasm
--shards 4 against the one-card run (device counting) of the phase-4
sample, GFAs byte-identical.

Usage: python chip_smoke.py [--mbp 1000] [--cards 4]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
K, S = 1001, 31
SYNCASM_FLAGS = ["-k", str(K), "-s", str(S), "-c", "30"]
PF_SUFFIXES = [f"{t}.{x}" for t in ("mito", "pltd") for x in ("ctg.fasta", "ctg.bed", "gfa", "bed")]
E2E_MBP = 40  # phase-4/5 sample: small enough for the CPU-backend child


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 0
def phase_device(cards: int):
    """Returns (card description, devices); fails without a GPU."""
    check(
        os.path.isdir(os.path.join(REPO, "oatk_tpu")),
        f"the oatk_tpu package is not beside {os.path.basename(__file__)}",
    )
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax
    import jaxlib

    import oatk_tpu  # noqa: F401  (x64 and the compile cache, before first use)

    devs = jax.devices()
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"devices: {devs}")
    check(devs[0].platform == "gpu", f"no GPU: JAX found {devs[0].platform}")
    check(len(devs) >= cards, f"{cards} card(s) asked for, {len(devs)} found")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}") from e
    check(smi, "nvidia-smi listed no card")
    card = smi[0].strip()
    log(f"card: {card}")
    return card, devs


# ---------------------------------------------------------------- phase 1
def phase_compile(fa: str) -> None:
    """Compile every chunk shape the loader cuts from ``fa`` (native
    parse + pack of each segment) and the device-count programs at the
    capacity the loader sizes for it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oatk_tpu.asm.reads import expected_key_lanes, loader_chunks
    from oatk_tpu.index.devcount import _cap_quantum, _jits
    from oatk_tpu.kernels.syncmer import extract_hoco_fused

    data = open(fa, "rb").read()
    shapes: dict = {}
    for B, Lp, max_out, n_cap, _blob in loader_chunks(data, K, S):
        shapes[(B, Lp, n_cap, max_out)] = shapes.get((B, Lp, n_cap, max_out), 0) + 1
    cap = _cap_quantum(expected_key_lanes(len(data), K, S))
    del data

    (keys, write), _inv, _grow, finalize = _jits()
    lane_cap = 0
    t_all = time.perf_counter()
    for (B, Lp, n_cap, max_out), n in sorted(shapes.items()):
        blob = jax.ShapeDtypeStruct((B * Lp // 4 + 4 * B + 4 * n_cap,), jnp.uint8)
        t0 = time.perf_counter()
        comp = extract_hoco_fused.lower(
            blob, B=B, Lp=Lp, n_cap=n_cap, w=K, s=S, max_out=max_out
        ).compile()
        log(f"phase 1: extract_hoco_fused B={B} Lp={Lp} n_cap={n_cap} "
            f"max_out={max_out} ({n} chunks): compile "
            f"{time.perf_counter() - t0:.2f} s; {_mem(comp)}")
        out_cap = -(-max_out // 2048) * 2048
        t0 = time.perf_counter()
        comp = keys.lower(
            jax.ShapeDtypeStruct((3, max_out + 1), jnp.int64),
            jax.ShapeDtypeStruct((B,), jnp.int64), Lp=Lp, out_cap=out_cap,
        ).compile()
        log(f"phase 1: devcount keys B={B} Lp={Lp}: compile "
            f"{time.perf_counter() - t0:.2f} s; {_mem(comp)}")
        lane_cap = max(lane_cap, out_cap)
    bufs = [jax.ShapeDtypeStruct((cap,), d) for d in
            (jnp.uint64, jnp.uint64, jnp.uint64, jnp.uint32, jnp.int32)]
    lanes = [jax.ShapeDtypeStruct((lane_cap,), d) for d in
             (jnp.uint64, jnp.uint64, jnp.uint64, jnp.uint32, jnp.int32)]
    t0 = time.perf_counter()
    comp = write.lower(*bufs, *lanes, np.int32(0)).compile()
    log(f"phase 1: devcount append cap={cap}: compile "
        f"{time.perf_counter() - t0:.2f} s; {_mem(comp)}")
    t0 = time.perf_counter()
    comp = finalize.lower(*bufs).compile()
    log(f"phase 1: devcount finalize cap={cap}: compile "
        f"{time.perf_counter() - t0:.2f} s; {_mem(comp)}")
    log(f"phase 1: {len(shapes)} extract shapes, all programs compiled in "
        f"{time.perf_counter() - t_all:.2f} s")


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory analysis unavailable"
    mb = lambda x: f"{x / 1e6:.1f} MB"  # noqa: E731
    return (f"args {mb(m.argument_size_in_bytes)}, out {mb(m.output_size_in_bytes)}, "
            f"temp {mb(m.temp_size_in_bytes)}")


# ---------------------------------------------------------------- phase 2
def phase_selection(work: str, n_reads: int = 200) -> None:
    import numpy as np

    from genome_sim import random_genome
    from oatk_tpu.asm.reads import load_and_extract
    from oatk_tpu.kernels.oracle import syncmers_of_read_oracle

    rng = np.random.default_rng(2026)
    reads = []
    for _ in range(n_reads):
        r = bytearray(random_genome(rng, int(rng.integers(10_000, 25_001))).encode())
        for _ in range(int(rng.integers(0, 4))):  # N runs of 1-30 bases
            p = int(rng.integers(len(r)))
            e = min(len(r), p + int(rng.integers(1, 31)))
            r[p:e] = b"N" * (e - p)
        reads.append(bytes(r))
    fa = os.path.join(work, "select.fa")
    with open(fa, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">s%d\n%s\n" % (i, r))
    t0 = time.perf_counter()
    db = load_and_extract([fa], K, S)
    dt = time.perf_counter() - t0
    check(db is not None and db.n == n_reads, "fused loader did not run")
    n_scm = 0
    for i, r in enumerate(reads):
        ora = syncmers_of_read_oracle(np.frombuffer(r, np.uint8), K, S, i)
        got = db.reads[i]
        for f in ("m_pos", "s_mer", "k_mer"):
            check(np.array_equal(getattr(got, f), getattr(ora, f)),
                  f"phase 2: read {i} {f} differs from the oracle")
        n_scm += len(ora.m_pos)
    n_n = sum(r.count(b"N") for r in reads)
    log(f"phase 2: {n_reads} reads, {sum(map(len, reads))} bp, {n_n} N, "
        f"{n_scm} syncmers: m_pos/s_mer/k_mer exact vs oracle "
        f"(loader {dt:.2f} s incl. compile)")


# ---------------------------------------------------------------- phases 3-5
def _sample(work: str, name: str, mbp: int, scale: float, seed: int):
    import numpy as np

    from validate_large import build_genomes, build_reads, write_fa

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    mito, pltd = build_genomes(rng, scale)
    reads = build_reads(rng, mito, pltd, mbp)
    fa = os.path.join(work, f"{name}.fa")
    write_fa(fa, reads)
    bp = sum(len(r) for r in reads)
    log(f"{name}: {len(reads)} reads, {bp / 1e6:.1f} Mbp generated in "
        f"{time.perf_counter() - t0:.1f} s")
    return fa, mito, pltd


def _syncasm(fa: str, pref: str, extra=()):
    """syncasm CLI in-process; returns its SyncasmResult."""
    import oatk_tpu.cli.syncasm as cli

    got = {}
    real = cli.syncasm

    def keep(*a, **k):
        got["res"] = real(*a, **k)
        return got["res"]

    cli.syncasm = keep
    try:
        t0 = time.perf_counter()
        rc = cli.main([*SYNCASM_FLAGS, "-t", str(_threads()), *extra, "-o", pref, fa])
        wall = time.perf_counter() - t0
    finally:
        cli.syncasm = real
    check(rc == 0, f"syncasm exited {rc}")
    return got["res"], wall


def _threads() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


def _annotate(work: str, gfa: str, mito: str, pltd: str):
    """Synthetic nhmmscan tblout files for the mito/plastid segments."""
    import numpy as np

    from validate_large import MITO_GENES, PLTD_GENES, classify_segments, scatter, write_tblout

    seg_class, seg_len = classify_segments(gfa, mito, pltd)
    counts = {}
    for c in seg_class.values():
        counts[c] = counts.get(c, 0) + 1
    rng = np.random.default_rng(777)
    paths = []
    for kind, genes in (("mito", MITO_GENES), ("pltd", PLTD_GENES)):
        hits = scatter(rng, {s for s, c in seg_class.items() if c == kind}, seg_len, genes)
        p = os.path.join(work, f"{kind}.tblout")
        write_tblout(p, hits)
        paths.append(p)
    return counts, paths


def _pathfinder(gfa: str, annots, pref: str) -> None:
    from oatk_tpu.cli.pathfinder import main as pathfinder_main

    rc = pathfinder_main(["-m", annots[0], "-p", annots[1], "-o", pref, gfa])
    check(rc == 0, f"pathfinder exited {rc}")
    for suff in PF_SUFFIXES:
        check(os.path.exists(f"{pref}.{suff}"), f"pathfinder wrote no {suff}")


def phase_main(work: str, sample, mbp: int, card: str) -> None:
    fa, mito, pltd = sample
    pref = os.path.join(work, "main")
    res, wall = _syncasm(fa, pref)
    rdb = res.read_db
    check(getattr(rdb, "load_timings", None) is not None, "fused loader did not run")
    dc = _devcount_of(res, "phase 3")
    counts, annots = _annotate(work, pref + ".utg.final.gfa", mito, pltd)
    check(counts.get("mito") and counts.get("pltd"),
          f"mito/plastid unitigs not found: {counts}")
    t0 = time.perf_counter()
    _pathfinder(pref + ".utg.final.gfa", annots, pref + ".pf")
    t_pf = time.perf_counter() - t0
    log(f"phase 3: {mbp} Mbp syncasm wall {wall:.2f} s (after phase-1 compile), pathfinder "
        f"{t_pf:.2f} s; {dc}; segments {counts}")
    log(f"phase 3 stage walls [{card}]: "
        + " ".join(f"{k}={v:.3f}s" for k, v in (res.timings or {}).items()))
    log(f"phase 3 load split [{card}]: "
        + " ".join(f"{k}={v:.3f}s" for k, v in rdb.load_timings.items()))


def _e2e_sample(work: str):
    # organelle genomes scaled to 0.4 (~33 Mbp of organelle reads) plus
    # nuclear background up to E2E_MBP
    return _sample(work, "e2e", E2E_MBP, 0.4, 20260818)


@contextlib.contextmanager
def _device_count():
    """Force device-resident counting, which the loader starts on its
    own only from ~60 MB of input (OATK_TPU_COUNT=auto)."""
    old = os.environ.get("OATK_TPU_COUNT")
    os.environ["OATK_TPU_COUNT"] = "device"
    try:
        yield
    finally:
        if old is None:
            del os.environ["OATK_TPU_COUNT"]
        else:
            os.environ["OATK_TPU_COUNT"] = old


def _devcount_of(res, where: str) -> str:
    dc = getattr(res.read_db, "_devcount_stats", None)
    check(dc is not None, f"{where}: device counting did not attach")
    return (f"devcount cap={dc.cap} appends={dc.n_append} grows={dc.n_grow} "
            f"invalidations={dc.n_invalidate}")


def _same(a: str, b: str) -> int:
    da, db = open(a, "rb").read(), open(b, "rb").read()
    check(da == db, f"{os.path.basename(a)} differs from {os.path.basename(b)}")
    return len(da)


def phase_e2e(work: str) -> None:
    fa, mito, pltd = _e2e_sample(work)
    gpu = os.path.join(work, "gpu")
    cpu = os.path.join(work, "cpu")
    with _device_count():
        res, wall = _syncasm(fa, gpu)
    dc = _devcount_of(res, "phase 4")
    counts, annots = _annotate(work, gpu + ".utg.final.gfa", mito, pltd)
    _pathfinder(gpu + ".utg.final.gfa", annots, gpu + ".pf")
    # the CPU backend in a child process that never opens the card, with
    # the host sort as the independent reference for device counting
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               OATK_TPU_COUNT="host")
    t0 = time.perf_counter()
    for cmd in (
        ["oatk_tpu.cli.syncasm", *SYNCASM_FLAGS, "-t", str(_threads()), "-o", cpu, fa],
        ["oatk_tpu.cli.pathfinder", "-m", annots[0], "-p", annots[1],
         "-o", cpu + ".pf", cpu + ".utg.final.gfa"],
    ):
        cp = subprocess.run([sys.executable, "-m", *cmd], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=900)
        check(cp.returncode == 0,
              f"CPU-backend {cmd[0]} exited {cp.returncode}: {cp.stderr[-2000:]}")
    t_cpu = time.perf_counter() - t0
    n = 0
    for suff in (".utg.gfa", ".utg.final.gfa", *(".pf." + x for x in PF_SUFFIXES)):
        _same(gpu + suff, cpu + suff)
        n += 1
    log(f"phase 4: {E2E_MBP} Mbp, {n} output files byte-identical, GPU with {dc} "
        f"vs CPU backend with host counting (GPU syncasm {wall:.2f} s, first run "
        f"in this process; CPU child {t_cpu:.2f} s); segments {counts}")


def phase_sharded(work: str, cards: int) -> None:
    fa, _m, _p = _e2e_sample(work)
    one = os.path.join(work, "one")
    shd = os.path.join(work, "sharded")
    with _device_count():
        res, w1 = _syncasm(fa, one)
    dc = _devcount_of(res, "phase 5 one-card run")
    _r, w4 = _syncasm(fa, shd, ["--shards", str(cards)])
    for suff in (".utg.gfa", ".utg.final.gfa"):
        n = _same(one + suff, shd + suff)
        check(b"S\t" in open(one + suff, "rb").read(), f"empty assembly in {suff}")
        log(f"phase 5: {suff} byte-identical, {n} bytes")
    log(f"phase 5: {E2E_MBP} Mbp syncasm one card ({dc}) {w1:.2f} s, --shards "
        f"{cards} {w4:.2f} s (each the first run of its programs in this process)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=int, default=1000, help="phase-3 sample size [1000]")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path on four cards")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    work = os.path.join(REPO, "smoke_work")
    try:
        card, devs = phase_device(args.cards)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        sample: list = []
        phases = (
            [lambda: phase_sharded(work, args.cards)]
            if args.cards > 1
            else [
                lambda: sample.append(_sample(work, "main", args.mbp, 1.0, 20260817)),
                lambda: phase_compile(sample[0][0]),
                lambda: phase_selection(work),
                lambda: phase_main(work, sample[0], args.mbp, card),
                lambda: phase_e2e(work),
            ]
        )
        for ph in phases:
            t0 = time.perf_counter()
            ph()
            log(f"phase done in {time.perf_counter() - t0:.1f} s "
                f"(total {time.perf_counter() - t_start:.1f} s)")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"card: {card}")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
