"""Fused native-parse -> device loader (load_and_extract): the
pipelined multi-segment flow must reproduce the host oracle exactly
(positions, strands, s-mers, Murmur hashes, hoco streams), including
FASTQ input, gz input, multi-file sid continuity, and the -D capped
sequential flow."""
import gzip

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads

W, S = 51, 11


def _write_fa(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i} extra comment\n{r}\n")


def _oracle_db(paths, max_data=0):
    from oatk_tpu.asm.reads import extract_all_syncmers
    from oatk_tpu.io.fastx import read_fastx

    return extract_all_syncmers(read_fastx(paths, max_data), W, S, use_device=False)


def _assert_same(db, ref):
    assert db.n == ref.n
    for a, b in zip(db.reads, ref.reads):
        assert a.sid == b.sid and a.name == b.name
        assert a.hoco_l == b.hoco_l
        assert np.array_equal(a.hoco_code, b.hoco_code)
        assert np.array_equal(a.ho_rl, b.ho_rl)
        assert np.array_equal(a.is_n, b.is_n)
        assert np.array_equal(a.m_pos, b.m_pos)
        assert np.array_equal(a.s_mer, b.s_mer)
        assert np.array_equal(a.k_mer, b.k_mer)


@pytest.fixture
def reads():
    rng = np.random.default_rng(20260817)
    g = random_genome(rng, 6000)
    return sample_reads(rng, g, coverage=6, read_len=900, err_rate=0.01)


def test_pipelined_loader_equals_oracle(tmp_path, monkeypatch, reads):
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    monkeypatch.setattr(R, "_SEG_BYTES", 4096)  # force many segments
    db = R.load_and_extract([str(fa)], W, S)
    assert db is not None
    _assert_same(db, _oracle_db([str(fa)]))
    # loader carries the whole-run hoco streams; the contract is
    # hoco_off[i] + in-read position addressing (segments may leave
    # gaps between reads -- consumers always carry per-read lengths)
    assert db.hoco_flat is not None and len(db.hoco_off) == db.n + 1
    prev_end = 0
    for i, r in enumerate(db.reads):
        o0 = int(db.hoco_off[i])
        assert o0 >= prev_end  # disjoint ascending regions
        prev_end = o0 + r.hoco_l
        assert np.array_equal(db.hoco_flat[o0 : o0 + r.hoco_l], r.hoco_code)
        assert np.array_equal(db.rl_flat[o0 : o0 + r.hoco_l], r.ho_rl)


def test_loader_chunks_unpack_to_every_read(tmp_path, monkeypatch, reads):
    """loader_chunks cuts the pipelined loader's blobs; _unpack_blob
    turns each back into one row per read: the read's hoco codes, then
    padding code 5."""
    import jax.numpy as jnp

    from oatk_tpu import native
    from oatk_tpu.asm import reads as R
    from oatk_tpu.kernels.syncmer import _unpack_blob

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    monkeypatch.setattr(R, "_SEG_BYTES", 4096)  # force many segments
    ref = _oracle_db([str(fa)])
    want = sorted(r.hoco_code.tobytes() for r in ref.reads)
    got = []
    chunks = list(R.loader_chunks(fa.read_bytes(), W, S))
    assert len(chunks) > 1
    for B, Lp, max_out, n_cap, blob in chunks:
        assert max_out % 1024 == 0 and len(blob) == B * Lp // 4 + 4 * B + 4 * n_cap
        codes, sel_codes = (np.asarray(a) for a in _unpack_blob(jnp.asarray(blob), B, Lp, n_cap))
        hl = np.frombuffer(blob[B * Lp // 4 : B * Lp // 4 + 4 * B].tobytes(), np.int32)
        for row, n in zip(codes, hl):
            if n:
                assert (row[n:] == 5).all()
                got.append(row[:n].tobytes())
        assert (sel_codes[codes == 5] == 5).all()
    assert sorted(got) == want


def test_pipelined_loader_fastq_gz_multifile(tmp_path, monkeypatch, reads):
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads[:20]):
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    fgz = tmp_path / "r2.fa.gz"
    with gzip.open(fgz, "wt") as f:
        for i, r in enumerate(reads[20:40]):
            f.write(f">g{i}\n{r}\n")
    paths = [str(fq), str(fgz)]
    monkeypatch.setattr(R, "_SEG_BYTES", 2048)
    db = R.load_and_extract(paths, W, S)
    assert db is not None
    _assert_same(db, _oracle_db(paths))


def test_capped_loader_equals_oracle(tmp_path, reads):
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    cap = sum(len(r) for r in reads) // 2
    db = R.load_and_extract([str(fa)], W, S, max_data=cap)
    assert db is not None
    ref = _oracle_db([str(fa)], max_data=cap)
    # reference cap semantics: stop once cumulative raw length >= cap
    assert 0 < db.n < len(reads)
    _assert_same(db, ref)


def test_overflow_retry(tmp_path, monkeypatch):
    """A tiny max_out forces the capacity-overflow retry path."""
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    g = random_genome(rng, 3000)
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), sample_reads(rng, g, coverage=3, read_len=600))
    real_round_up = R._round_up
    clamped = {"done": False}

    def tiny_round_up(x, m):
        # clamp only the FIRST max_out estimate (distinguished from the
        # n_cap calls by its >=1024 input); the retry then recomputes a
        # proper capacity from the reported n_sel
        if m == 1024 and x > 512 and not clamped["done"]:
            clamped["done"] = True
            return 64
        return real_round_up(x, m)

    monkeypatch.setattr(R, "_round_up", tiny_round_up)
    db = R.load_and_extract([str(fa)], W, S)
    monkeypatch.undo()
    assert db is not None
    _assert_same(db, _oracle_db([str(fa)]))


def test_optimistic_guard_fallback(tmp_path, monkeypatch, reads):
    """A FASTA-leading file with embedded FASTQ records trips the
    concurrent '\\n@' guard: the optimistic '\\n>' split is discarded,
    the verified retry (unsplit parse) runs, and — because the native
    parser rejects mixed buffers by design — the loader returns None so
    the caller falls back to the Python reader, exactly as before the
    optimistic split existed.  The fallback must match the oracle."""
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R
    from oatk_tpu.asm.pipeline import load_reads

    if not native.available():
        pytest.skip("native library unavailable")
    mixed = tmp_path / "m.fa"
    with open(mixed, "w") as f:
        for i, r in enumerate(reads[:15]):
            f.write(f">r{i}\n{r}\n")
        for i, r in enumerate(reads[15:30]):
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    monkeypatch.setattr(R, "_SEG_BYTES", 2048)  # force the split attempt
    assert R.load_and_extract([str(mixed)], W, S) is None
    db = load_reads([str(mixed)], W, S, use_device=False)
    _assert_same(db, _oracle_db([str(mixed)]))


def test_bounded_parse_equals_slice_parse(reads):
    """parse_fastx_hoco(data, start, end) (zero-copy range) must equal
    parse_fastx_hoco(data[start:end]) for every record boundary cut."""
    from oatk_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    blob = b"".join(f">r{i}\n{r}\n".encode() for i, r in enumerate(reads[:24]))
    cuts = native.fasta_record_cuts(blob, 5)
    assert cuts is not None
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        a = native.parse_fastx_hoco(blob, c0, c1)
        b = native.parse_fastx_hoco(blob[c0:c1])
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y)


def test_compaction_order_hp_rich_many_segments(tmp_path, monkeypatch):
    """Regression lock for segment-region bookkeeping under large hoco
    shrink.

    Each segment parses in place at its byte range and the flats keep
    those regions (with gaps where hoco shrank -- formerly a leftward
    memmove compaction whose ordering hazard corrupted hp-rich inputs,
    caught live as off-by-N homopolymer runs in the final GFA at
    30 Mbp).  This case maximizes shrink: ~50 segments of hp-rich
    reads; every per-read window of the flats must equal the oracle.
    """
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(42)
    g = random_genome(rng, 20_000, hp_prob=0.5, max_hp=12)
    reads = sample_reads(rng, g, coverage=60, read_len=1500, err_rate=0.005)
    fa = tmp_path / "hp.fa"
    _write_fa(str(fa), reads)
    monkeypatch.setattr(R, "_SEG_BYTES", 24 * 1024)
    db = R.load_and_extract([str(fa)], W, S)
    assert db is not None
    _assert_same(db, _oracle_db([str(fa)]))
    prev_end = 0
    for i, r in enumerate(db.reads):
        o0 = int(db.hoco_off[i])
        assert o0 >= prev_end
        prev_end = o0 + r.hoco_l
        assert np.array_equal(db.hoco_flat[o0 : o0 + r.hoco_l], r.hoco_code)
        assert np.array_equal(db.rl_flat[o0 : o0 + r.hoco_l], r.ho_rl)


def test_device_hoco_parity(tmp_path, monkeypatch, reads):
    """OATK_TPU_DEVICE_HOCO=1: raw-ASCII upload + on-device hoco must
    reproduce the host-hoco oracle exactly -- syncmers AND the fetched
    hoco arrays (codes, run lengths, N flags)."""
    from oatk_tpu.asm import reads as R
    from oatk_tpu.asm.pipeline import load_reads

    rd = list(reads)
    # sprinkle Ns: the device hoco phase must reproduce the N handling
    r0 = list(rd[0])
    r0[50] = "N"
    r0[51] = "N"
    rd[0] = "".join(r0)
    fa = tmp_path / "dh.fa"
    _write_fa(str(fa), rd)
    monkeypatch.setenv("OATK_TPU_DEVICE_HOCO", "1")
    routed = []
    real = R._extract_device_hoco
    monkeypatch.setattr(
        R, "_extract_device_hoco", lambda *a, **k: routed.append(1) or real(*a, **k)
    )
    db = load_reads([str(fa)], W, S)
    assert routed, "the knob must route through the device-hoco extractor"
    monkeypatch.delenv("OATK_TPU_DEVICE_HOCO")
    _assert_same(db, _oracle_db([str(fa)]))


def test_load_reads_takes_fused_loader_on_any_backend(tmp_path, monkeypatch, reads):
    """load_reads runs the fused native loader + device selection on
    whatever backend JAX has (the CPU here): the Python-reader fallback
    must not be reached, and the result equals the oracle."""
    from oatk_tpu import native
    from oatk_tpu.asm import pipeline as P

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)

    def no_fallback(*a, **k):
        raise AssertionError("load_reads fell back to read_fastx")

    monkeypatch.setattr(P, "read_fastx", no_fallback)
    db = P.load_reads([str(fa)], W, S)
    monkeypatch.undo()
    _assert_same(db, _oracle_db([str(fa)]))
