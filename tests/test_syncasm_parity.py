"""End-to-end syncasm GFA parity vs the reference binary on synthetic data."""
import subprocess
from pathlib import Path

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

REFBIN = Path("/root/refbin")


def _parse_gfa(path):
    segs = {}
    links = set()
    for line in open(path):
        f = line.rstrip("\n").split("\t")
        if f[0] == "S":
            tags = {t.split(":")[0]: t.split(":", 2)[2] for t in f[3:]}
            segs[f[1]] = (f[2], tags.get("LN"), tags.get("KC"), tags.get("SC"), tags.get("EC"))
        elif f[0] == "L":
            links.add((f[1], f[2], f[3], f[4], f[5], f[6] if len(f) > 6 else ""))
    return segs, links


def _run_pair(tmp_path, reads, k, s, c, ec=False, unzip=0):
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    ref_pref = tmp_path / "ref"
    args = [str(REFBIN / "syncasm"), "-k", str(k), "-s", str(s), "-c", str(c), "-o", str(ref_pref)]
    if not ec:
        args.append("--no-read-ec")
    args += ["--unzip-round", str(unzip), str(fa)]
    subprocess.run(args, check=True, capture_output=True)

    from oatk_tpu.asm.pipeline import syncasm

    my_pref = tmp_path / "mine"
    syncasm([str(fa)], k=k, s=s, min_k_cov=c, do_ec=ec, do_unzip=unzip, out=str(my_pref))
    return ref_pref, my_pref


def _assert_gfa_equal(ref_file, my_file):
    ref_segs, ref_links = _parse_gfa(ref_file)
    my_segs, my_links = _parse_gfa(my_file)
    assert set(ref_segs) == set(my_segs), (
        f"segment sets differ: ref={sorted(ref_segs)} mine={sorted(my_segs)}"
    )
    for name in ref_segs:
        assert ref_segs[name] == my_segs[name], (
            f"segment {name} differs:\nref ={ref_segs[name][:2]}...\nmine={my_segs[name][:2]}..."
        )
    assert ref_links == my_links


@pytest.mark.parametrize("seed,glen", [(5, 12000), (6, 30000)])
def test_utg_gfa_parity_no_ec(tmp_path, seed, glen):
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, glen)
    reads = sample_reads(rng, genome, coverage=12, read_len=3000)
    ref_pref, my_pref = _run_pair(tmp_path, reads, k=251, s=17, c=3)
    _assert_gfa_equal(f"{ref_pref}.utg.gfa", f"{my_pref}.utg.gfa")
    _assert_gfa_equal(f"{ref_pref}.utg.final.gfa", f"{my_pref}.utg.final.gfa")


@pytest.mark.parametrize(
    "seed,ec,unzip",
    [(21, True, 0), (22, False, 3), (23, True, 3)],
    ids=["ec1-unzip0", "ec0-unzip3", "ec1-unzip3"],
)
def test_utg_gfa_parity_ec_unzip(tmp_path, seed, ec, unzip):
    """EC/unzip-on parity in the fast suite:
    exercises asm/ec.py (C13) and asm/unzip.py (C15) against the
    reference with sequencing errors so EC has real work to do."""
    rng = np.random.default_rng(seed)
    a = random_genome(rng, 7000)
    r = random_genome(rng, 2200)
    b = random_genome(rng, 6000)
    genome = a + r + b + r  # repeat so unzip engages
    reads = sample_reads(rng, genome, coverage=14, read_len=2200, err_rate=0.002)
    ref_pref, my_pref = _run_pair(tmp_path, reads, k=251, s=17, c=3, ec=ec, unzip=unzip)
    _assert_gfa_equal(f"{ref_pref}.utg.gfa", f"{my_pref}.utg.gfa")
    _assert_gfa_equal(f"{ref_pref}.utg.final.gfa", f"{my_pref}.utg.final.gfa")


def test_utg_gfa_parity_with_repeat(tmp_path):
    # genome with an exact long repeat creating a junction
    rng = np.random.default_rng(9)
    a = random_genome(rng, 8000)
    r = random_genome(rng, 2500)
    b = random_genome(rng, 8000)
    genome = a + r + b + r  # circular with duplicated repeat r
    reads = sample_reads(rng, genome, coverage=15, read_len=2000)
    ref_pref, my_pref = _run_pair(tmp_path, reads, k=251, s=17, c=3)
    _assert_gfa_equal(f"{ref_pref}.utg.gfa", f"{my_pref}.utg.gfa")
    _assert_gfa_equal(f"{ref_pref}.utg.final.gfa", f"{my_pref}.utg.final.gfa")


def test_utg_gfa_parity_long_homopolymers(tmp_path):
    """Run-length overflow path: homopolymer runs far beyond 255 bp must
    survive the u8 run-1 storage (saturated entries resolved through the
    overflow list, the reference sr_t ho_l_rl analogue) and reproduce
    the reference's run-length-expanded consensus byte-for-byte."""
    rng = np.random.default_rng(31)
    a = random_genome(rng, 6000)
    b = random_genome(rng, 6000)
    c = random_genome(rng, 5000)
    # three monster homopolymers (300/700/1200 bp) inside unique context
    genome = a + "A" * 300 + b + "G" * 700 + c + "T" * 1200
    reads = sample_reads(rng, genome, coverage=14, read_len=2500)
    ref_pref, my_pref = _run_pair(tmp_path, reads, k=251, s=17, c=3)
    _assert_gfa_equal(f"{ref_pref}.utg.gfa", f"{my_pref}.utg.gfa")
    _assert_gfa_equal(f"{ref_pref}.utg.final.gfa", f"{my_pref}.utg.final.gfa")
    # the expanded homopolymers must actually be present in a segment
    # (.utg.gfa: the final graph collapses entirely on this tiny genome,
    # identically on both sides)
    seqs = "".join(seq for seq, *_ in _parse_gfa(f"{my_pref}.utg.gfa")[0].values())
    assert ("A" * 300 in seqs or "T" * 300 in seqs)
    assert ("G" * 700 in seqs or "C" * 700 in seqs)
    assert ("T" * 1200 in seqs or "A" * 1200 in seqs)
