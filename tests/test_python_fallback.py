"""Full-pipeline parity with the native C library disabled: every stage
must fall back to its pure-Python implementation and still match the
reference byte-for-byte (the deployment story when no C compiler is
available)."""
import subprocess
from pathlib import Path

import numpy as np

from genome_sim import random_genome, sample_reads, write_reads
from test_syncasm_parity import _assert_gfa_equal

REFBIN = Path("/root/refbin")


def test_syncasm_parity_without_native(tmp_path, monkeypatch):
    from oatk_tpu import native

    rng = np.random.default_rng(61)
    a = random_genome(rng, 6000)
    r = random_genome(rng, 2000)
    b = random_genome(rng, 5000)
    genome = a + r + b + r
    reads = sample_reads(rng, genome, coverage=14, read_len=2000, err_rate=0.002)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "151", "-s", "13", "-c", "3",
         "--unzip-round", "3", "-o", str(tmp_path / "ref"), str(fa)],
        check=True, capture_output=True,
    )

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "parse_fastx_hoco", lambda *a, **k: None)
    monkeypatch.setattr(native, "parse_fastx_hoco_mt", lambda *a, **k: None)
    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fa)], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
            out=str(tmp_path / "mine"))
    monkeypatch.undo()
    _assert_gfa_equal(tmp_path / "ref.utg.gfa", tmp_path / "mine.utg.gfa")
    _assert_gfa_equal(tmp_path / "ref.utg.final.gfa", tmp_path / "mine.utg.final.gfa")


def test_device_em_and_consensus_optins_parity(tmp_path, monkeypatch, capsys):
    """The opt-in device paths (OATK_TPU_DEVICE_EM: coverage EM as one
    lax.while_loop dispatch; OATK_TPU_DEVICE_CONSENSUS: run-length
    consensus reductions on device, which also forces the per-unitig
    route past the batched native emitter) must reproduce the reference
    GFAs byte-for-byte.  DEVICE_EM is
    quarantined as experimental (its float reduction order is not
    parity-guaranteed by construction) -- the run must say so."""
    rng = np.random.default_rng(62)
    a = random_genome(rng, 6000)
    r = random_genome(rng, 2000)
    b = random_genome(rng, 5000)
    genome = a + r + b + r
    reads = sample_reads(rng, genome, coverage=14, read_len=2000, err_rate=0.002)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "151", "-s", "13", "-c", "3",
         "--unzip-round", "3", "-o", str(tmp_path / "ref"), str(fa)],
        check=True, capture_output=True,
    )

    from oatk_tpu.asm.pipeline import syncasm

    from oatk_tpu.asm import coverage as _cov

    monkeypatch.setattr(_cov, "_device_em_warned", False)
    monkeypatch.setenv("OATK_TPU_DEVICE_EM", "1")
    monkeypatch.setenv("OATK_TPU_DEVICE_CONSENSUS", "1")
    syncasm([str(fa)], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
            out=str(tmp_path / "mine_dev"))
    monkeypatch.undo()
    err = capsys.readouterr().err
    assert "OATK_TPU_DEVICE_EM is experimental" in err
    _assert_gfa_equal(tmp_path / "ref.utg.gfa", tmp_path / "mine_dev.utg.gfa")
    _assert_gfa_equal(
        tmp_path / "ref.utg.final.gfa", tmp_path / "mine_dev.utg.final.gfa"
    )
