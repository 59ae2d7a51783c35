"""numt/nupt + heteroplasmy parity stress.

Two read-data structures the organelle classifier stack exists for:

- numts/nupts: organelle fragments embedded in nuclear background at
  nuclear (low) coverage -- the confounder behind the DBSCAN coverage
  clustering and seed gating (/root/reference/path.c:3416-3445,
  3821-3967);
- heteroplasmy: low-frequency organelle variants surfacing as bubbles
  that stress the (super-)bubble protection logic
  (/root/reference/graph.c:382-432).

Each case runs the FULL pipeline on both sides (reference binaries vs
oatk_tpu) and asserts byte-identical outputs across randomized seeds.
"""
import subprocess
from pathlib import Path

import numpy as np
import pytest

from genome_sim import (
    embed_numts,
    heteroplasmic_minor,
    random_genome,
    sample_reads,
    write_reads,
)
from test_pathfinder_parity import (
    MITO_GENES,
    _cmp_files,
    _parse_gfa_segs,
    _scatter_genes,
    _write_tblout,
)

REFBIN = Path("/root/refbin")

pytestmark = pytest.mark.skipif(
    not (REFBIN / "syncasm").exists(), reason="no reference binaries"
)


@pytest.mark.parametrize("seed", [101, 102, 103, 104, 105, 106])
def test_heteroplasmy_parity(tmp_path, seed):
    """Major + minor organelle haplotypes (SNV heteroplasmy) mixed at
    ~25%: the minor allele passes the coverage filter and forms bubbles;
    graph cleaning (protection vs popping) must match the reference
    byte-for-byte through EC + 3 unzip rounds."""
    rng = np.random.default_rng(seed)
    a = random_genome(rng, 7000)
    rep = random_genome(rng, 1800)
    b = random_genome(rng, 6000)
    major = a + rep + b + rep
    minor = heteroplasmic_minor(rng, major, n_snv=14)
    reads = sample_reads(rng, major, coverage=24, read_len=2400,
                         err_rate=0.002, hp_frac=0.85)
    reads += sample_reads(rng, minor, coverage=8, read_len=2400,
                          err_rate=0.002, hp_frac=0.85)
    rng.shuffle(reads)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)

    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "251", "-s", "17", "-c", "3",
         "--unzip-round", "3", "-o", str(tmp_path / "ref"), str(fa)],
        check=True, capture_output=True,
    )
    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fa)], k=251, s=17, min_k_cov=3, do_ec=True, do_unzip=3,
            out=str(tmp_path / "mine"))
    for suff in (".utg.gfa", ".utg.final.gfa"):
        ref = (tmp_path / f"ref{suff}").read_bytes()
        mine = (tmp_path / f"mine{suff}").read_bytes()
        assert ref == mine, f"{suff} differs on heteroplasmy (seed {seed})"
    assert b"S\t" in (tmp_path / "ref.utg.gfa").read_bytes()


@pytest.mark.parametrize("seed", [201, 202, 203, 204, 205, 206])
def test_numt_parity(tmp_path, seed):
    """Organelle genome at deep coverage + nuclear background carrying
    embedded (diverged) organelle fragments at ~3x: assembly AND the
    downstream classification -- gene hits land on low-coverage numt
    segments too, so the DBSCAN coverage clustering and seed gates do
    real work -- must be byte-identical to the reference."""
    rng = np.random.default_rng(seed)
    organelle = random_genome(rng, 18000)
    # divergence (0, 0.01): some inserts are IDENTICAL to the organelle
    # (shared syncmers at nuclear coverage), others nuclear-unique;
    # nuclear coverage 8 > min_k_cov so the background assembles into
    # low-coverage segments the classifier must separate
    nuclear = embed_numts(
        rng, random_genome(rng, 45000), organelle,
        n_inserts=6, len_range=(500, 5000), divergence=(0.0, 0.01),
    )
    reads = sample_reads(rng, organelle, coverage=40, read_len=2600,
                         err_rate=0.002, hp_frac=0.85)
    reads += sample_reads(rng, nuclear, coverage=8, read_len=2600,
                          err_rate=0.002, circular=False, hp_frac=0.85)
    rng.shuffle(reads)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)

    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "251", "-s", "17", "-c", "3",
         "--unzip-round", "3", "-o", str(tmp_path / "ref"), str(fa)],
        check=True, capture_output=True,
    )
    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fa)], k=251, s=17, min_k_cov=3, do_ec=True, do_unzip=3,
            out=str(tmp_path / "mine"))
    for suff in (".utg.gfa", ".utg.final.gfa"):
        ref = (tmp_path / f"ref{suff}").read_bytes()
        mine = (tmp_path / f"mine{suff}").read_bytes()
        assert ref == mine, f"{suff} differs on numt input (seed {seed})"

    # classification stress: mito gene hits over ALL segments (real
    # organelle + numt-bearing nuclear), forcing the coverage DBSCAN +
    # seed gating to separate them
    gfa = tmp_path / "ref.utg.final.gfa"
    segs = _parse_gfa_segs(str(gfa))
    if not segs:
        pytest.skip("empty assembly at this seed")
    hits = _scatter_genes(rng, segs, MITO_GENES * 2, n_hits=min(16, len(segs) * 2))
    mito = tmp_path / "mito.txt"
    _write_tblout(mito, hits)

    subprocess.run(
        [str(REFBIN / "pathfinder"), "-m", str(mito),
         "-o", str(tmp_path / "refpf"), str(gfa)],
        check=True, capture_output=True,
    )
    from oatk_tpu.pathfind.driver import pathfinder

    pathfinder(str(gfa), str(mito), None, out_pref=str(tmp_path / "minepf"))
    for suff in ("ctg.fasta", "ctg.bed", "gfa", "bed"):
        _cmp_files(tmp_path / f"refpf.mito.{suff}", tmp_path / f"minepf.mito.{suff}")
