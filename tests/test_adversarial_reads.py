"""Adversarial-input parity: chimeric reads, adapter remnants, coverage
dropouts, contaminant carry-over and quality-skewed FASTQ must flow
through the full pipeline byte-identically to the reference binary
(the closest offline stand-in for real organelle read structure)."""
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from genome_sim import (
    random_genome, revcomp, sample_reads_adversarial, write_fastq,
)

REFBIN = Path("/root/refbin")


@pytest.mark.skipif(not (REFBIN / "syncasm").exists(), reason="no reference binaries")
@pytest.mark.parametrize("seed", [11, 12])
def test_adversarial_fastq_parity(tmp_path, seed):
    rng = np.random.default_rng(seed)
    a = random_genome(rng, 9000)
    rep = random_genome(rng, 1800)
    b = random_genome(rng, 7000)
    genome = a + rep + b + rep
    contaminant = random_genome(rng, 30000)
    reads = sample_reads_adversarial(
        rng, genome, coverage=18, read_len=2400, err_rate=0.002,
        chimera_frac=0.04, adapter_frac=0.04,
        dropout=(0.25, 0.2), contaminant=contaminant, contaminant_frac=0.06,
    )
    fq = tmp_path / "reads.fq"
    write_fastq(str(fq), reads, rng=rng)

    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "251", "-s", "17", "-c", "3",
         "--unzip-round", "3", "-o", str(tmp_path / "ref"), str(fq)],
        check=True, capture_output=True,
    )
    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fq)], k=251, s=17, min_k_cov=3, do_ec=True, do_unzip=3,
            out=str(tmp_path / "mine"))
    for suff in (".utg.gfa", ".utg.final.gfa"):
        ref = (tmp_path / f"ref{suff}").read_bytes()
        mine = (tmp_path / f"mine{suff}").read_bytes()
        assert ref == mine, f"{suff} differs on adversarial input (seed {seed})"
    # the main genome must survive the artifacts: non-trivial assembly
    assert b"S\t" in (tmp_path / "ref.utg.gfa").read_bytes()
