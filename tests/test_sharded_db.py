"""Multi-chip sharded syncmer collection on the virtual 8-device CPU mesh:
the sharded path (data-parallel extraction + hash-range all_to_all routing
+ per-shard device sort, dist/sharded_db.py) must produce a SyncmerDB --
and downstream GFA -- byte-identical to the single-device path and the
reference binary."""
import subprocess
from pathlib import Path

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

REFBIN = Path("/root/refbin")


def _write_dataset(tmp_path, seed=42, glen=20000, cov=10, rl=2500, err=0.001):
    rng = np.random.default_rng(seed)
    g = random_genome(rng, glen)
    reads = sample_reads(rng, g, coverage=cov, read_len=rl, err_rate=err)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    return fa


def test_sharded_db_identical_to_host(tmp_path):
    """DB-level equality: ids, hashes, smers, coverage, position lists and
    the per-read k_mer rewrite all match the host lexsort path."""
    import jax

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    fa = _write_dataset(tmp_path)

    from oatk_tpu.asm.pipeline import load_reads
    from oatk_tpu.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu.dist.sharding import make_mesh
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    db1 = load_reads([str(fa)], 251, 17, 0, True)
    scm1 = collect_syncmer_db(db1)

    db2, coll = load_and_extract_sharded([str(fa)], 251, 17, make_mesh(8))
    assert db1.n == db2.n
    for r1, r2 in zip(db1.reads, db2.reads):
        assert np.array_equal(r1.m_pos, r2.m_pos)
        assert np.array_equal(r1.s_mer, r2.s_mer)
    scm2 = coll.build(db2)

    assert scm1.n == scm2.n
    assert np.array_equal(scm1.h, scm2.h)
    assert np.array_equal(scm1.s, scm2.s)
    assert np.array_equal(scm1.cov, scm2.cov)
    for a, b in zip(scm1.m_pos, scm2.m_pos):
        assert np.array_equal(a, b)
    for r1, r2 in zip(db1.reads, db2.reads):
        assert np.array_equal(r1.k_mer, r2.k_mer)


@pytest.mark.parametrize("n_shards", [8, 5, 1])
def test_sharded_syncasm_gfa_parity(tmp_path, n_shards):
    """Full syncasm with EC + unzip on the mesh: byte-identical GFA vs the
    reference binary (non-power-of-two shard count exercises the clamped
    owner function)."""
    rng = np.random.default_rng(23)
    a = random_genome(rng, 7000)
    r = random_genome(rng, 2200)
    b = random_genome(rng, 6000)
    genome = a + r + b + r
    reads = sample_reads(rng, genome, coverage=14, read_len=2200, err_rate=0.002)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)

    subprocess.run(
        [str(REFBIN / "syncasm"), "-k", "251", "-s", "17", "-c", "3",
         "--unzip-round", "3", "-o", str(tmp_path / "ref"), str(fa)],
        check=True, capture_output=True,
    )

    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fa)], k=251, s=17, min_k_cov=3, do_ec=True, do_unzip=3,
            out=str(tmp_path / "mine"), shards=n_shards)
    for suff in (".utg.gfa", ".utg.final.gfa"):
        ref = (tmp_path / f"ref{suff}").read_bytes()
        mine = (tmp_path / f"mine{suff}").read_bytes()
        assert ref == mine, f"{suff} differs under shards={n_shards}"


def test_sharded_pallas_inner_matches_host(tmp_path):
    """The sharded inner extractor (per-device selection over
    host-precompressed hoco codes) must yield the same DB as the
    single-device path."""
    fa = _write_dataset(tmp_path, seed=42, glen=15000, cov=8, rl=2000)

    from oatk_tpu.asm.pipeline import load_reads
    from oatk_tpu.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu.dist.sharding import make_mesh
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    db1 = load_reads([str(fa)], 151, 13, 0, True)
    scm1 = collect_syncmer_db(db1)
    db2, coll = load_and_extract_sharded([str(fa)], 151, 13, make_mesh(8))
    scm2 = coll.build(db2)
    assert scm1.n == scm2.n
    assert np.array_equal(scm1.h, scm2.h)
    assert np.array_equal(scm1.cov, scm2.cov)
    for a, b in zip(scm1.m_pos, scm2.m_pos):
        assert np.array_equal(a, b)


def test_sharded_multifile_and_empty_shards(tmp_path):
    """Multiple input files and a shard count exceeding the interesting
    hash ranges still reproduce the host path."""
    rng = np.random.default_rng(7)
    fa1 = tmp_path / "a.fa"
    fa2 = tmp_path / "b.fa"
    write_reads(str(fa1), sample_reads(rng, random_genome(rng, 9000), 8, 1800))
    write_reads(str(fa2), sample_reads(rng, random_genome(rng, 6000), 8, 1500))

    from oatk_tpu.asm.pipeline import load_reads
    from oatk_tpu.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu.dist.sharding import make_mesh
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    files = [str(fa1), str(fa2)]
    db1 = load_reads(files, 151, 13, 0, True)
    scm1 = collect_syncmer_db(db1)
    db2, coll = load_and_extract_sharded(files, 151, 13, make_mesh(8))
    scm2 = coll.build(db2)
    assert scm1.n == scm2.n
    assert np.array_equal(scm1.h, scm2.h)
    assert np.array_equal(scm1.cov, scm2.cov)
