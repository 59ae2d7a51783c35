"""pathfinder output parity vs the reference binary, using syncasm GFAs
from synthetic genomes plus synthetic nhmmscan tblout annotations."""
import subprocess
from pathlib import Path

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

REFBIN = Path("/root/refbin")

MITO_GENES = ["nad1", "nad2", "cox1", "cox2", "atp6", "rps3", "rrn18", "trnM"]
PLTD_GENES = ["psbA", "rbcL", "atpA", "psaB", "rpoB", "ndhF", "matK", "rps4"]


def _make_gfa(tmp_path, rng, glen, cov=15, read_len=3000, k=251, s=17):
    genome = random_genome(rng, glen)
    reads = sample_reads(rng, genome, coverage=cov, read_len=read_len)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    pref = tmp_path / "asm"
    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", str(k), "-s", str(s), "-c", "3",
         "--no-read-ec", "--unzip-round", "0", "-o", str(pref), str(fa)],
        check=True, capture_output=True,
    )
    return f"{pref}.utg.final.gfa"


def _parse_gfa_segs(gfa):
    segs = {}
    for line in open(gfa):
        f = line.split("\t")
        if f[0] == "S":
            segs[f[1]] = len(f[2])
    return segs


def _write_tblout(path, hits):
    """hits: (gene, seg, alifrom, alito, strand, evalue, score)"""
    with open(path, "w") as f:
        f.write("# nhmmscan tblout (synthetic)\n")
        for gene, seg, af, at, strand, ev, score in hits:
            modlen = at - af
            if strand == "-":
                af, at = at, af
            f.write(
                f"{gene} - {seg} - 1 {modlen} {af} {at} {af} {at} {modlen} "
                f"{strand} {ev:g} {score:.1f} 0.5 -\n"
            )


def _scatter_genes(rng, segs, genes, n_hits=None):
    hits = []
    seg_names = sorted(segs)
    for i, gene in enumerate(genes if n_hits is None else genes[:n_hits]):
        seg = seg_names[i % len(seg_names)]
        L = segs[seg]
        glen = int(rng.integers(300, 1200))
        start = int(rng.integers(1, max(2, L - glen)))
        strand = "+" if rng.random() < 0.5 else "-"
        hits.append((gene, seg, start, min(L, start + glen), strand, 1e-30, float(rng.integers(350, 900))))
    return hits


def _cmp_files(ref, mine):
    rd = open(ref).read()
    md = open(mine).read()
    assert rd == md, f"{ref} differs\n--- ref head ---\n{rd[:400]}\n--- mine head ---\n{md[:400]}"


def _run_both(tmp_path, gfa, mito_txt=None, pltd_txt=None, extra=()):
    args = [str(REFBIN / "pathfinder")]
    if mito_txt:
        args += ["-m", str(mito_txt)]
    if pltd_txt:
        args += ["-p", str(pltd_txt)]
    args += list(extra) + ["-o", str(tmp_path / "ref"), str(gfa)]
    subprocess.run(args, check=True, capture_output=True)

    from oatk_tpu.pathfind.driver import pathfinder

    pathfinder(
        str(gfa),
        str(mito_txt) if mito_txt else None,
        str(pltd_txt) if pltd_txt else None,
        out_pref=str(tmp_path / "mine"),
    )
    types = []
    if mito_txt:
        types.append("mito")
    if pltd_txt:
        types.append("pltd")
    for t in types:
        for suff in ("ctg.fasta", "ctg.bed", "gfa", "bed"):
            _cmp_files(tmp_path / f"ref.{t}.{suff}", tmp_path / f"mine.{t}.{suff}")


def test_pathfinder_single_circular_mito(tmp_path, rng):
    gfa = _make_gfa(tmp_path, rng, 30000)
    segs = _parse_gfa_segs(gfa)
    hits = _scatter_genes(rng, segs, MITO_GENES)
    mito = tmp_path / "mito.txt"
    _write_tblout(mito, hits)
    _run_both(tmp_path, gfa, mito_txt=mito)


def test_pathfinder_mito_and_pltd(tmp_path, rng):
    # two genomes -> two components; one annotated mito, other pltd
    g1 = random_genome(rng, 25000)
    g2 = random_genome(rng, 15000)
    reads = sample_reads(rng, g1, 14, 3000) + sample_reads(rng, g2, 20, 3000)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    pref = tmp_path / "asm"
    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "251", "-s", "17", "-c", "3",
         "--no-read-ec", "--unzip-round", "0", "-o", str(pref), str(fa)],
        check=True, capture_output=True,
    )
    gfa = f"{pref}.utg.final.gfa"
    segs = _parse_gfa_segs(gfa)
    seg_names = sorted(segs)
    # split: first half of segs = mito genes, second half = pltd genes
    half = max(1, len(seg_names) // 2)
    mito_hits = _scatter_genes(rng, {k: segs[k] for k in seg_names[:half]}, MITO_GENES)
    pltd_hits = _scatter_genes(rng, {k: segs[k] for k in seg_names[half:]} or segs, PLTD_GENES)
    mito = tmp_path / "mito.txt"
    pltd = tmp_path / "pltd.txt"
    _write_tblout(mito, mito_hits)
    _write_tblout(pltd, pltd_hits)
    _run_both(tmp_path, gfa, mito_txt=mito, pltd_txt=pltd)


def test_pathfinder_from_ec_unzip_assembly(tmp_path):
    """Pathfinder parity on a GFA produced by an EC + 3-round-unzip
    assembly with sequencing errors."""
    rng = np.random.default_rng(21)  # seed chosen so the erroneous assembly is non-empty
    a = random_genome(rng, 8000)
    r = random_genome(rng, 2400)
    b = random_genome(rng, 7000)
    genome = a + r + b + r
    reads = sample_reads(rng, genome, coverage=18, read_len=2300, err_rate=0.0015)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    pref = tmp_path / "asm"
    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "151", "-s", "13", "-c", "3",
         "--unzip-round", "3", "-o", str(pref), str(fa)],
        check=True, capture_output=True,
    )
    gfa = f"{pref}.utg.final.gfa"
    segs = _parse_gfa_segs(gfa)
    hits = _scatter_genes(rng, segs, MITO_GENES)
    mito = tmp_path / "mito.txt"
    _write_tblout(mito, hits)
    _run_both(tmp_path, gfa, mito_txt=mito)


def test_pathfinder_repeat_graph(tmp_path, rng):
    # genome with repeat -> multi-unitig graph with copy numbers
    a = random_genome(rng, 9000)
    r = random_genome(rng, 2600)
    b = random_genome(rng, 9000)
    genome = a + r + b + r
    reads = sample_reads(rng, genome, coverage=16, read_len=2400)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    pref = tmp_path / "asm"
    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "251", "-s", "17", "-c", "3",
         "--no-read-ec", "--unzip-round", "0", "-o", str(pref), str(fa)],
        check=True, capture_output=True,
    )
    gfa = f"{pref}.utg.final.gfa"
    segs = _parse_gfa_segs(gfa)
    hits = _scatter_genes(rng, segs, MITO_GENES)
    mito = tmp_path / "mito.txt"
    _write_tblout(mito, hits)
    _run_both(tmp_path, gfa, mito_txt=mito)


def test_single_gene_srcc_nan_parity(tmp_path):
    """SRCC with one total gene divides 0 by 0: the reference's IEEE
    arithmetic yields NaN that flows through rotation/sort/selection
    (path.c:1704); the Python port must reproduce that instead of
    raising ZeroDivisionError.  Regression for stress seed 50001."""
    import stress_pathfinder

    desc = stress_pathfinder.one_case(50001, tmp_path)
    assert "skipped" not in desc or desc  # byte-compared inside one_case
