"""Minicircle (-M) mode: self-consistency plus byte parity against the
reference `oatk -M` binary driven with the same stub nhmmscan
(/root/reference/path_finder.c:539-930, oatk.c:438-441)."""
import stat
import subprocess
from pathlib import Path

import numpy as np

from genome_sim import random_genome, sample_reads, write_reads
from test_tools_parity import FAKE_NHMMSCAN

REFBIN = Path("/root/refbin")


def _rolling_circle_reads(rng, glen=4000, n=60):
    genome = random_genome(rng, glen)
    tandem = genome * 4
    reads = []
    for _ in range(n):
        start = int(rng.integers(len(genome)))
        L = int(rng.integers(6000, 11000))
        reads.append((tandem + tandem)[start : start + L])
    return genome, reads


def test_oatk_minicircle_parity_vs_reference(tmp_path, rng):
    """The reference oatk -M run with a stub
    nhmmscan on identical reads must produce byte-identical annotation
    and .mini.{gfa,bed,ctg.fasta,ctg.bed} outputs."""
    genome, reads = _rolling_circle_reads(rng)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)

    exe = tmp_path / "fake_nhmmscan"
    exe.write_text(FAKE_NHMMSCAN.replace("gene$i", "mini$i"))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "fake.hmm").write_text("dummy\n")

    common = ["-k", "101", "-s", "13", "-c", "3", "--no-read-ec",
              "--unzip-round", "0", "-M", "-m", str(tmp_path / "fake.hmm"),
              "--nhmmscan", str(exe)]
    subprocess.run(
        [str(REFBIN / "oatk"), *common, "-o", str(tmp_path / "ref.asm"), str(fa)],
        check=True, capture_output=True,
    )

    from oatk_tpu.cli.oatk import main

    ret = main([*common, "-o", str(tmp_path / "mine.asm"), str(fa)])
    assert ret == 0
    for suff in ("annot_mito.txt", "mini.gfa", "mini.bed",
                 "mini.ctg.fasta", "mini.ctg.bed"):
        a = (tmp_path / f"ref.asm.{suff}").read_bytes()
        b = (tmp_path / f"mine.asm.{suff}").read_bytes()
        assert a == b, (
            f"{suff} differs\n--- ref ---\n{a[:400]!r}\n--- mine ---\n{b[:400]!r}"
        )


def test_oatk_minicircle_mode(tmp_path, rng):
    # small circular "animal mito"-like genome; reads long enough to span
    # it multiple times (rolling-circle style templates)
    genome = random_genome(rng, 4000)
    tandem = genome * 4
    reads = []
    for _ in range(60):
        start = int(rng.integers(len(genome)))
        L = int(rng.integers(6000, 11000))
        seq = (tandem + tandem)[start : start + L]
        reads.append(seq)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)

    exe = tmp_path / "fake_nhmmscan"
    exe.write_text(FAKE_NHMMSCAN.replace("gene$i", "mini$i"))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "fake.hmm").write_text("dummy\n")

    from oatk_tpu.cli.oatk import main

    ret = main([
        "-k", "101", "-s", "13", "-c", "3", "--no-read-ec", "--unzip-round", "0",
        "-M", "-m", str(tmp_path / "fake.hmm"), "--nhmmscan", str(exe),
        "-o", str(tmp_path / "oatk.asm"), str(fa),
    ])
    assert ret == 0
    fasta = (tmp_path / "oatk.asm.mini.ctg.fasta").read_text()
    assert fasta.startswith(">")
    seq = "".join(fasta.splitlines()[1:])
    # the extracted minicircle unit should be ~ the 4 kb monomer
    assert abs(len(seq) - len(genome)) < 500, len(seq)
    gfa = (tmp_path / "oatk.asm.mini.gfa").read_text()
    assert gfa.startswith("H\t")
