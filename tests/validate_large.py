"""Large-scale organelle-realistic validation (manual).

Synthesizes a >=100 Mbp HiFi-like dataset modelled on a plant sample:

- mito-like circular genome (~370 kbp) carrying a long direct repeat
  (recombination-active repeats are the hallmark of plant mito genomes);
- pltd-like circular genome with the canonical quadripartite
  LSC / IR / SSC / IR' structure (large inverted repeat pair);
- "nuclear" background: long random linear sequences at low coverage.

Runs the reference syncasm and oatk_tpu syncasm (full flags: k=1001,
EC on, 3 unzip rounds) on identical reads, requires byte-identical
GFAs, then drives reference pathfinder vs oatk_tpu pathfinder with a
deterministic synthetic annotation (genes placed on the segments whose
sequence maps back to each source genome) and requires all output files
byte-identical.

Usage: python tests/validate_large.py [--mbp 110] [--shards N] [--keep]
Writes a summary line suitable for PARITY.md.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))

from genome_sim import random_genome, revcomp, sample_reads  # noqa: E402

REFBIN = Path("/root/refbin")

MITO_GENES = ["nad1", "nad2", "nad4", "nad5", "cox1", "cox2", "cox3",
              "atp1", "atp6", "atp9", "cob", "rps3", "rps4", "rrn18", "rrn26"]
PLTD_GENES = ["psbA", "rbcL", "atpA", "atpB", "psaA", "psaB", "rpoB",
              "rpoC1", "ndhF", "matK", "rps4", "rrn16", "rrn23"]


def build_genomes(rng, scale=1.0):
    # mito: 370 kb circular with a 12 kb direct repeat ~180 kb apart
    core_a = random_genome(rng, int(160_000 * scale))
    rep = random_genome(rng, int(12_000 * scale))
    core_b = random_genome(rng, int(186_000 * scale))
    mito = core_a + rep + core_b + rep
    # pltd: LSC 86 kb + IR 25 kb + SSC 18 kb + IR'
    lsc = random_genome(rng, int(86_000 * scale))
    ir = random_genome(rng, int(25_000 * scale))
    ssc = random_genome(rng, int(18_000 * scale))
    pltd = lsc + ir + ssc + revcomp(ir)
    return mito, pltd


def build_reads(rng, mito, pltd, target_mbp):
    # organelle coverage far above nuclear, as in real samples; HiFi-like
    # error profile: ~0.1%/bp of which 85% are homopolymer-length indels
    # (absorbed by hoco compression, as on real instruments)
    reads = []
    reads += sample_reads(rng, mito, coverage=120, read_len=15_000,
                          err_rate=0.001, hp_frac=0.85)
    reads += sample_reads(rng, pltd, coverage=250, read_len=15_000,
                          err_rate=0.001, hp_frac=0.85)
    organelle_bp = sum(len(r) for r in reads)
    nuc_bp_needed = target_mbp * 1_000_000 - organelle_bp
    # nuclear background: 3x coverage of distinct random "chromosome" chunks
    n_chunks = 8
    chunk = int(nuc_bp_needed / 3 / n_chunks)
    if chunk > 20_000:
        for _ in range(n_chunks):
            g = random_genome(rng, chunk)
            reads += sample_reads(rng, g, coverage=3, read_len=15_000,
                                  err_rate=0.001, circular=False, hp_frac=0.85)
    rng.shuffle(reads)
    return reads


def write_fa(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")


def classify_segments(gfa, mito, pltd):
    """Map each GFA segment to its source genome by exact substring
    match (sampling the segment middle; hoco-free synthetic genomes so
    consensus == source sequence)."""
    mito2 = mito + mito
    pltd2 = pltd + pltd
    mito2rc = revcomp(mito2)
    pltd2rc = revcomp(pltd2)
    seg_class = {}
    seg_len = {}
    for line in open(gfa):
        if not line.startswith("S\t"):
            continue
        f = line.rstrip("\n").split("\t")
        name, seq = f[1], f[2]
        seg_len[name] = len(seq)
        probe = seq[len(seq) // 2 - 250 : len(seq) // 2 + 250] if len(seq) > 600 else seq
        if probe in mito2 or probe in mito2rc:
            seg_class[name] = "mito"
        elif probe in pltd2 or probe in pltd2rc:
            seg_class[name] = "pltd"
        else:
            seg_class[name] = "nucl"
    return seg_class, seg_len


def write_tblout(path, hits):
    with open(path, "w") as f:
        f.write("# nhmmscan tblout (synthetic large-validation)\n")
        for gene, seg, af, at, strand, ev, score in hits:
            modlen = at - af
            if strand == "-":
                af, at = at, af
            f.write(
                f"{gene} - {seg} - 1 {modlen} {af} {at} {af} {at} {modlen} "
                f"{strand} {ev:g} {score:.1f} 0.5 -\n"
            )


def scatter(rng, segs, seg_len, genes):
    hits = []
    seg_names = sorted(segs)
    if not seg_names:
        return hits
    for i, gene in enumerate(genes):
        seg = seg_names[i % len(seg_names)]
        L = seg_len[seg]
        glen = int(rng.integers(500, 1500))
        start = int(rng.integers(1, max(2, L - glen)))
        strand = "+" if rng.random() < 0.5 else "-"
        hits.append((gene, seg, start, min(L, start + glen), strand, 1e-40,
                     float(rng.integers(400, 900))))
    return hits


def cmp_files(a, b, what):
    da, db = open(a, "rb").read(), open(b, "rb").read()
    assert da == db, f"{what} differs ({a} vs {b})"
    return len(da)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=int, default=110)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="genome size scale (use 0.1 for a quick smoke run)")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--warm", action="store_true",
                    help="run syncasm twice in-process; report the warm wall")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()

    wd = Path(args.workdir or tempfile.mkdtemp(prefix="oatk_large_"))
    wd.mkdir(parents=True, exist_ok=True)
    print(f"workdir: {wd}", flush=True)

    rng = np.random.default_rng(20260817)
    mito, pltd = build_genomes(rng, args.scale)
    fa = wd / "reads.fa"
    meta = wd / "reads.meta"
    stamp = f"mbp={args.mbp} scale={args.scale}"
    if fa.exists():
        # reuse the workdir dataset (Gbp-scale generation is minutes);
        # the genomes above are re-derived so segment classification and
        # annotation scatter stay consistent with the stored reads
        have = meta.read_text().strip() if meta.exists() else "<unstamped>"
        if have != stamp:
            sys.exit(
                f"workdir {wd} holds a dataset generated with '{have}', "
                f"but this run asked for '{stamp}'; use a fresh --workdir "
                f"or delete reads.fa"
            )
        n_reads = total_bp = 0
        with open(fa) as f:
            for line in f:
                if line.startswith(">"):
                    n_reads += 1
                else:
                    total_bp += len(line) - 1
        print(f"dataset (reused): {n_reads} reads, {total_bp/1e6:.1f} Mbp", flush=True)
    else:
        reads = build_reads(rng, mito, pltd, args.mbp)
        total_bp = sum(len(r) for r in reads)
        write_fa(fa, reads)
        meta.write_text(stamp + "\n")
        print(f"dataset: {len(reads)} reads, {total_bp/1e6:.1f} Mbp", flush=True)

    flags = ["-k", "1001", "-s", "31", "-c", "30", "--unzip-round", "3"]

    t0 = time.time()
    subprocess.run([str(REFBIN / "syncasm"), *flags, "-t", "4",
                    "-o", str(wd / "ref"), str(fa)], check=True, capture_output=True)
    t_ref = time.time() - t0
    print(f"reference syncasm: {t_ref:.1f} s", flush=True)

    from oatk_tpu.asm.pipeline import syncasm

    t0 = time.time()
    res = syncasm([str(fa)], k=1001, s=31, min_k_cov=30, do_ec=True, do_unzip=3,
                  out=str(wd / "mine"), shards=args.shards)
    t_mine = time.time() - t0
    print(f"oatk_tpu syncasm: {t_mine:.1f} s (shards={args.shards})", flush=True)
    if args.warm:
        # second in-process run on the now-compiled shape vocabulary:
        # a single cold run conflates the XLA compiles with the
        # pipeline wall.  Warm-run timing matches bench.py's
        # compile-once-stream-many protocol (the production regime).
        t0 = time.time()
        res = syncasm([str(fa)], k=1001, s=31, min_k_cov=30, do_ec=True,
                      do_unzip=3, out=str(wd / "mine"), shards=args.shards)
        t_mine = time.time() - t0
        print(f"oatk_tpu syncasm (warm): {t_mine:.1f} s", flush=True)
    tm = res.timings or {}
    if tm:
        print("stage walls: " + " ".join(f"{k}={v:.3f}s" for k, v in tm.items()),
              flush=True)
    dc = getattr(res.read_db, "_devcount_stats", None)
    if dc is not None:
        # device-counting evidence (at-scale runs): buffer
        # capacity, growth recompiles, chunk appends, overflow/discard
        # invalidations
        print(
            f"devcount: cap={dc.cap} lanes ({dc.cap * 24 / 1e6:.0f} MB keys) "
            f"appends={dc.n_append} grows={dc.n_grow} "
            f"invalidations={dc.n_invalidate}",
            flush=True,
        )
    lt = getattr(res.read_db, "load_timings", None)
    if lt:
        print("load split: " + " ".join(f"{k}={v:.3f}s" for k, v in lt.items()),
              flush=True)

    for suff in (".utg.gfa", ".utg.final.gfa"):
        n = cmp_files(wd / f"ref{suff}", wd / f"mine{suff}", suff)
        print(f"{suff}: byte-identical ({n} bytes)", flush=True)

    # ---- pathfinder stage on the (identical) assembly ----
    gfa = wd / "ref.utg.final.gfa"
    seg_class, seg_len = classify_segments(gfa, mito, pltd)
    counts = {}
    for v in seg_class.values():
        counts[v] = counts.get(v, 0) + 1
    print(f"segment classes: {counts}", flush=True)
    rng2 = np.random.default_rng(777)
    mito_hits = scatter(rng2, {s for s, c in seg_class.items() if c == "mito"},
                        seg_len, MITO_GENES)
    pltd_hits = scatter(rng2, {s for s, c in seg_class.items() if c == "pltd"},
                        seg_len, PLTD_GENES)
    write_tblout(wd / "mito.txt", mito_hits)
    write_tblout(wd / "pltd.txt", pltd_hits)

    t0 = time.time()
    subprocess.run(
        [str(REFBIN / "pathfinder"), "-m", str(wd / "mito.txt"),
         "-p", str(wd / "pltd.txt"), "-o", str(wd / "refpf"), str(gfa)],
        check=True, capture_output=True)
    t_refpf = time.time() - t0

    from oatk_tpu.pathfind.driver import pathfinder

    t0 = time.time()
    pathfinder(str(gfa), str(wd / "mito.txt"), str(wd / "pltd.txt"),
               out_pref=str(wd / "minepf"))
    t_minepf = time.time() - t0
    print(f"pathfinder: ref {t_refpf:.1f} s, mine {t_minepf:.1f} s", flush=True)

    n_out = 0
    for t in ("mito", "pltd"):
        for suff in ("ctg.fasta", "ctg.bed", "gfa", "bed"):
            cmp_files(wd / f"refpf.{t}.{suff}", wd / f"minepf.{t}.{suff}",
                      f"{t}.{suff}")
            n_out += 1
    print(f"pathfinder outputs: {n_out}/8 byte-identical", flush=True)
    print(
        f"PARITY_ROW | {total_bp/1e6:.1f} Mbp synthetic plant sample "
        f"(mito 370kb w/ 12kb direct repeat, pltd 147kb LSC-IR-SSC-IR', "
        f"nuclear 3x background) | syncasm ref {t_ref:.1f}s vs oatk_tpu "
        f"{t_mine:.1f}s (shards={args.shards}) | .utg.gfa, .utg.final.gfa, "
        f"8 pathfinder files byte-identical",
        flush=True,
    )
    if not args.keep and args.workdir is None:
        import shutil
        shutil.rmtree(wd, ignore_errors=True)


if __name__ == "__main__":
    main()
