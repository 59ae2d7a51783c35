"""Degenerate-input parity: empty/short/all-N/homopolymer reads must
drive syncasm to the same outputs (or same empty results) as the
reference binary."""
import subprocess
from pathlib import Path

import numpy as np
import pytest

from genome_sim import random_genome
from test_syncasm_parity import _assert_gfa_equal

REFBIN = Path("/root/refbin")


def _run_pair(tmp_path, fa_text, k=51, s=11, c=1):
    fa = tmp_path / "reads.fa"
    fa.write_text(fa_text)
    cp = subprocess.run(
        [str(REFBIN / "syncasm"), "-k", str(k), "-s", str(s), "-c", str(c),
         "--no-read-ec", "--unzip-round", "0", "-o", str(tmp_path / "ref"), str(fa)],
        capture_output=True,
    )
    from oatk_tpu.asm.pipeline import syncasm

    try:
        syncasm([str(fa)], k=k, s=s, min_k_cov=c, do_ec=False, do_unzip=0,
                out=str(tmp_path / "mine"))
        mine_ok = True
    except SystemExit:
        mine_ok = False
    return cp.returncode, mine_ok, tmp_path


def test_reads_shorter_than_k(tmp_path, rng):
    body = "".join(f">r{i}\n{random_genome(rng, 30)}\n" for i in range(5))
    ref_rc, _, wd = _run_pair(tmp_path, body)
    # reference survives with an empty assembly; so must we
    if (wd / "ref.utg.final.gfa").exists() and (wd / "mine.utg.final.gfa").exists():
        _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")


def test_all_n_reads(tmp_path):
    body = ">r0\n" + "N" * 500 + "\n>r1\n" + "N" * 300 + "\n"
    ref_rc, _, wd = _run_pair(tmp_path, body)
    if (wd / "ref.utg.final.gfa").exists() and (wd / "mine.utg.final.gfa").exists():
        _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")


def test_homopolymer_only_reads(tmp_path):
    body = ">r0\n" + "A" * 2000 + "\n>r1\n" + "ACGT" * 500 + "\n"
    ref_rc, _, wd = _run_pair(tmp_path, body)
    if (wd / "ref.utg.final.gfa").exists() and (wd / "mine.utg.final.gfa").exists():
        _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")


def test_mixed_degenerate_with_real(tmp_path, rng):
    g = random_genome(rng, 8000)
    src = g + g
    parts = [">deg0\nNNNNN\n>deg1\nAAAA\n"]
    for i in range(40):
        st = int(rng.integers(8000))
        parts.append(f">r{i}\n{src[st:st+1500]}\n")
    parts.append(">deg2\n" + "N" * 100 + "\n")
    ref_rc, _, wd = _run_pair(tmp_path, "".join(parts), k=151, s=13, c=2)
    assert ref_rc == 0
    _assert_gfa_equal(wd / "ref.utg.gfa", wd / "mine.utg.gfa")
    _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")


def test_lowercase_and_u_bases(tmp_path, rng):
    """Lower-case bases and U fold like the reference's seq_nt4 table."""
    g = random_genome(rng, 6000)
    src = g + g
    parts = []
    for i in range(30):
        st = int(rng.integers(6000))
        seq = src[st : st + 1200]
        if i % 3 == 0:
            seq = seq.lower()
        elif i % 3 == 1:
            seq = seq.replace("T", "U")
        parts.append(f">r{i}\n{seq}\n")
    ref_rc, _, wd = _run_pair(tmp_path, "".join(parts), k=101, s=13, c=2)
    assert ref_rc == 0
    _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")


def test_multiline_fasta_records(tmp_path, rng):
    """Sequences wrapped at 60/80/7 columns parse identically to the
    reference (homopolymer runs span line breaks; the memchr-based line
    scan keeps prev/run state across lines of one record)."""
    g = random_genome(rng, 8000, hp_prob=0.3)
    src = g + g
    parts = []
    for i, width in enumerate([60, 80, 7, 133, 1]):
        for j in range(8):
            st = int(rng.integers(8000))
            seq = src[st : st + 1500]
            wrapped = "\n".join(seq[x : x + width] for x in range(0, len(seq), width))
            parts.append(f">r{i}_{j}\n{wrapped}\n")
    ref_rc, _, wd = _run_pair(tmp_path, "".join(parts), k=101, s=13, c=2)
    assert ref_rc == 0
    _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")


def test_crlf_line_endings(tmp_path, rng):
    """CRLF (and a stray mid-line CR) inputs parse identically to the
    reference's kseq-style handling."""
    g = random_genome(rng, 6000)
    src = g + g
    parts = []
    for i in range(24):
        st = int(rng.integers(6000))
        seq = src[st : st + 1200]
        if i % 2 == 0:
            wrapped = "\r\n".join(seq[x : x + 70] for x in range(0, len(seq), 70))
            parts.append(f">r{i}\r\n{wrapped}\r\n")
        else:
            parts.append(f">r{i}\n{seq}\n")
    ref_rc, _, wd = _run_pair(tmp_path, "".join(parts), k=101, s=13, c=2)
    assert ref_rc == 0
    _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")


def test_survives_input_that_segfaults_reference(tmp_path, rng):
    """Stress seed 30019 makes the reference binary segfault (rc -11)
    during unzip multiplexing; the rebuild must complete cleanly on the
    same reads (producing its own consistent output -- there is no
    oracle to compare against here, the reference never finishes)."""
    import subprocess

    from genome_sim import sample_reads

    r = np.random.default_rng(30019)
    ks = [(91, 13), (151, 13), (251, 17), (501, 21)][int(r.integers(4))]
    k, s = ks
    n_genomes = int(r.integers(1, 3))
    genome_parts = []
    for _ in range(n_genomes):
        glen = int(r.integers(6000, 25000))
        g = random_genome(r, glen)
        if r.random() < 0.5:
            rep = random_genome(r, int(r.integers(1500, 4000)))
            g = g + rep + random_genome(r, int(r.integers(3000, 8000))) + rep
        genome_parts.append(g)
    reads = []
    for g in genome_parts:
        cov = float(r.integers(8, 25))
        rl = int(r.integers(1200, 4000))
        err = float(r.choice([0.0, 0.0, 0.001, 0.003]))
        hp = float(r.choice([0.0, 0.85]))
        reads += sample_reads(r, g, cov, rl, err_rate=err, hp_frac=hp)
    r.shuffle(reads)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{x}\n" for i, x in enumerate(reads)))

    cp = subprocess.run(
        [str(REFBIN / "syncasm"), "-k", str(k), "-s", str(s), "-c", "2",
         "--unzip-round", "3", "-o", str(tmp_path / "ref"), str(fa)],
        capture_output=True,
    )
    assert cp.returncode == -11, "reference no longer crashes; re-pair this case"

    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fa)], k=k, s=s, min_k_cov=2, do_ec=True, do_unzip=3,
            out=str(tmp_path / "mine"))
    assert (tmp_path / "mine.utg.final.gfa").exists()


def test_mixed_degenerate_devcount_path(tmp_path, rng, monkeypatch):
    """Same degenerate mix (zero-syncmer N/homopolymer reads between
    real ones) forced through the production fused loader + device
    counting (full-fetch): the per-read view restore must hand every
    degenerate read empty arrays and keep byte parity."""
    from oatk_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    monkeypatch.setenv("OATK_TPU_COUNT", "device")
    g = random_genome(rng, 8000)
    src = g + g
    parts = [">deg0\nNNNNN\n>deg1\nAAAA\n"]
    for i in range(40):
        st = int(rng.integers(8000))
        parts.append(f">r{i}\n{src[st:st+1500]}\n")
    parts.append(">deg2\n" + "N" * 100 + "\n")
    ref_rc, _, wd = _run_pair(tmp_path, "".join(parts), k=151, s=13, c=2)
    assert ref_rc == 0
    _assert_gfa_equal(wd / "ref.utg.gfa", wd / "mine.utg.gfa")
    _assert_gfa_equal(wd / "ref.utg.final.gfa", wd / "mine.utg.final.gfa")
