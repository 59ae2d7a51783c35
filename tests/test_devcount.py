"""Device-resident counting (index/devcount.py): the device sort + id
assignment must reproduce the host lexsort DB exactly -- ids, coverage,
position lists, head hashes/smers, and the per-read k_mer rewrite --
including the multi-segment loader flow, the overflow-regrow path, and
the discarded-attempt invalidation."""
import numpy as np
import pytest

from genome_sim import random_genome, sample_reads

W, S = 51, 11


def _write_fa(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i} c\n{r}\n")


def _host_db(paths):
    from oatk_tpu.asm.reads import extract_all_syncmers
    from oatk_tpu.index.syncmer_db import collect_syncmer_db
    from oatk_tpu.io.fastx import read_fastx

    db = extract_all_syncmers(read_fastx(paths, 0), W, S, use_device=False)
    scm = collect_syncmer_db(db)
    return db, scm


def _dev_db(paths):
    from oatk_tpu.asm import reads as R
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    db = R.load_and_extract(paths, W, S, device_count=True)
    assert db is not None
    assert getattr(db, "_devcount", None) is not None
    assert all(r.k_mer is None for r in db.reads)  # khash never fetched
    scm = collect_syncmer_db(db)
    return db, scm


def _assert_db_equal(h, d):
    db1, scm1 = h
    db2, scm2 = d
    assert scm1.n == scm2.n
    assert np.array_equal(scm1.h, scm2.h)
    assert np.array_equal(scm1.s, scm2.s)
    assert np.array_equal(scm1.cov, scm2.cov)
    assert np.array_equal(scm1.mp_flat, scm2.mp_flat)
    assert np.array_equal(scm1.mp_off, scm2.mp_off)
    assert db1.n == db2.n
    for r1, r2 in zip(db1.reads, db2.reads):
        assert np.array_equal(r1.k_mer, r2.k_mer), r1.sid
        assert np.array_equal(r1.m_pos, r2.m_pos)
        assert np.array_equal(r1.s_mer, r2.s_mer)


@pytest.fixture
def reads():
    rng = np.random.default_rng(20260819)
    g = random_genome(rng, 8000)
    return sample_reads(rng, g, coverage=7, read_len=1100, err_rate=0.01)


def test_devcount_equals_host(tmp_path, monkeypatch, reads):
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    monkeypatch.setattr(R, "_SEG_BYTES", 4096)  # many segments
    _assert_db_equal(_host_db([str(fa)]), _dev_db([str(fa)]))


def test_devcount_multifile(tmp_path, monkeypatch, reads):
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    fa1 = tmp_path / "a.fa"
    fa2 = tmp_path / "b.fa"
    _write_fa(str(fa1), reads[:20])
    _write_fa(str(fa2), reads[20:40])
    monkeypatch.setattr(R, "_SEG_BYTES", 2048)
    paths = [str(fa1), str(fa2)]
    _assert_db_equal(_host_db(paths), _dev_db(paths))


def test_devcount_overflow_regrow(tmp_path, monkeypatch):
    """A clamped first max_out forces the overflow path: the overflowed
    chunk's device key lanes must be invalidated and the regrown chunk's
    keys appended, keeping the final DB identical."""
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    g = random_genome(rng, 3000)
    reads = sample_reads(rng, g, coverage=3, read_len=600)
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)

    real_round_up = R._round_up
    clamped = {"done": False}

    def tiny_round_up(x, m):
        if m == 1024 and x > 512 and not clamped["done"]:
            clamped["done"] = True
            return 64
        return real_round_up(x, m)

    monkeypatch.setattr(R, "_round_up", tiny_round_up)
    dev = _dev_db([str(fa)])
    monkeypatch.undo()
    assert clamped["done"], "overflow path not exercised"
    _assert_db_equal(_host_db([str(fa)]), dev)


def _force_fallback(monkeypatch, DC):
    """Patch DevCountState.build to always take the suspicious-cluster
    route (build_db_from_sorted over the fetched sorted keys); returns
    the call counter."""
    forced = {"n": 0}

    def forcing_build(self, read_db):
        # pretend every run is suspicious: state.build must route through
        # build_db_from_sorted (fetching sorted h/l/s) and match exactly
        import jax

        self.start_finalize()
        (gid_flat_d, m32_d, rs_sid_d, rs_pos_d, hh_d, hs_d,
         h1_d, l1_d, s1_d, scalars_d, *_pairs) = self._final
        self._final = None
        n_exp = self.n_occ
        n_reads = len(read_db.reads)
        if n_exp == 0:
            return None
        gran = max(4096, self.cap // 8)
        m = min(self.cap, -(-n_exp // gran) * gran)
        mr = min(self.cap, -(-min(n_reads, n_exp) // 4096) * 4096)
        scalars, m32_f, rs_sid, rs_pos, sh, sl, ss = jax.device_get(
            (scalars_d, m32_d[:m], rs_sid_d[:mr], rs_pos_d[:mr],
             h1_d[:m], l1_d[:m], s1_d[:m])
        )
        n_tot, n_scm, n_susp, n_pu, n_ru = (
            int(x) for x in np.asarray(scalars)
        )
        assert n_susp == 0  # sanity on real data
        assert n_tot == n_exp
        mc = np.zeros(n_reads, np.int64)
        rs_sid_v = np.asarray(rs_sid[:n_ru]).astype(np.int64)
        rs_pos_v = np.asarray(rs_pos[:n_ru]).astype(np.int64)
        mc[rs_sid_v] = np.diff(np.append(rs_pos_v, n_tot))
        offs = np.zeros(n_reads + 1, np.int64)
        np.cumsum(mc, out=offs[1:])
        sh = np.asarray(sh[:n_tot])
        sl = np.asarray(sl[:n_tot])
        ss = np.asarray(ss[:n_tot])
        sid_s = (sl >> np.uint64(32)).astype(np.int64)
        idx_s = ((sl >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
        sm_np = np.empty(n_tot, np.uint64)
        sm_np[offs[sid_s] + idx_s] = ss
        DC._restore_read_views(
            read_db, mc, offs, np.asarray(m32_f[:n_tot]), sm_np, None,
        )
        from oatk_tpu.index.syncmer_db import build_db_from_sorted

        forced["n"] += 1
        return build_db_from_sorted(read_db, sh, sl, ss, offs)

    monkeypatch.setattr(DC.DevCountState, "build", forcing_build)
    return forced


def test_devcount_collision_fallback(tmp_path, monkeypatch, reads):
    """Force the suspicious-cluster path: the host exact-sequence
    resolution over the fetched sorted keys must still match."""
    from oatk_tpu import native
    from oatk_tpu.index import devcount as DC

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads[:25])

    forced = _force_fallback(monkeypatch, DC)
    dev = _dev_db([str(fa)])
    monkeypatch.undo()
    assert forced["n"] == 1
    _assert_db_equal(_host_db([str(fa)]), dev)


def test_devcount_fallback_with_zero_syncmer_read(tmp_path, monkeypatch, reads):
    """The collision fallback must also rewrite k_mer for reads with ZERO
    syncmers (shorter than k): devcount loads leave k_mer=None until the
    id rewrite, and a None surviving into read_flats crashes the
    assembly (regression: build_db_from_sorted skipped n==0 reads)."""
    from oatk_tpu import native
    from oatk_tpu.index import devcount as DC

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    mixed = reads[:10] + ["ACGTACGTACGTACGTACGTACGTACGTAC"] + reads[10:20]
    _write_fa(str(fa), mixed)

    forced = _force_fallback(monkeypatch, DC)
    dev = _dev_db([str(fa)])
    monkeypatch.undo()
    assert forced["n"] == 1
    db2, _ = dev
    assert all(r.k_mer is not None for r in db2.reads)
    assert db2.reads[10].n == 0 and len(db2.reads[10].k_mer) == 0
    _assert_db_equal(_host_db([str(fa)]), dev)
    # the crash site: flats concatenate every per-read k_mer
    from oatk_tpu.asm.consensus import read_flats

    read_flats(db2)


def test_devcount_buffer_growth(tmp_path, monkeypatch, reads):
    """Force the pow4 cap-growth path (devcount._ensure: cap <<= 2 with
    a donated-pad grow jit): start from a tiny quantum with the
    file-size pre-hint disabled so every few chunks overflow the carry
    buffers.  The grown-buffer DB must equal the host lexsort DB
    exactly."""
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R
    from oatk_tpu.index import devcount

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    monkeypatch.setattr(R, "_SEG_BYTES", 4096)  # many chunks

    def tiny_quantum(x):
        c = 1 << 12
        while c < x:
            c <<= 2
        return c

    class NoHintState(devcount.DevCountState):
        # the loader pre-sizes cap_hint from the input volume; swallow
        # it so _ensure starts at the tiny quantum and must GROW
        @property
        def cap_hint(self):
            return 0

        @cap_hint.setter
        def cap_hint(self, v):
            pass

    monkeypatch.setattr(devcount, "_cap_quantum", tiny_quantum)
    monkeypatch.setattr(devcount, "DevCountState", NoHintState)

    db = R.load_and_extract([str(fa)], W, S, device_count=True)
    assert db is not None
    dc = db._devcount
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    scm = collect_syncmer_db(db)
    assert dc.n_grow > 0, "growth path not exercised"
    _assert_db_equal(_host_db([str(fa)]), (db, scm))


def test_devcount_pairs_match_host_graph(tmp_path, monkeypatch, reads):
    """The finalize's on-device arc-pair sort-reduce must yield exactly
    the host _read_adjacent_pairs + radix-sort unique/count result: the
    graphs built from either source are identical (arcs, covs, order)."""
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R
    from oatk_tpu.asm.scg import make_syncmer_graph

    if not native.available():
        pytest.skip("native library unavailable")
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    monkeypatch.setattr(R, "_SEG_BYTES", 4096)
    db_d, scm_d = _dev_db([str(fa)])
    dp = getattr(db_d, "_dev_pairs", None)
    assert dp is not None and dp[0] == db_d.version and len(dp[1]) > 0

    import copy

    scm_d2 = copy.deepcopy(scm_d)
    g_dev = make_syncmer_graph(db_d, scm_d, 0, 0.0)
    db_d._dev_pairs = None  # force the host pair path on the same reads
    g_host = make_syncmer_graph(db_d, scm_d2, 0, 0.0)
    for a, b in ((g_dev.utg, g_host.utg),):
        assert np.array_equal(a.av, b.av)
        assert np.array_equal(a.aw, b.aw)
        assert np.array_equal(np.asarray(a.acov), np.asarray(b.acov))
        assert np.array_equal(np.asarray(a.acomp), np.asarray(b.acomp))
        assert np.array_equal(np.asarray(a.alink), np.asarray(b.alink))
        assert np.array_equal(np.asarray(a.adel), np.asarray(b.adel))
    # filtered-graph flavor too (coverage gates + deletions applied)
    db_h, scm_h = _dev_db([str(fa)])
    assert getattr(db_h, "_dev_pairs", None) is not None
    g1 = make_syncmer_graph(db_h, scm_h, 3, 0.35)
    db_h._dev_pairs = None
    import copy as _c

    g2 = make_syncmer_graph(db_h, _c.deepcopy(scm_h), 3, 0.35)
    assert np.array_equal(g1.utg.av, g2.utg.av)
    assert np.array_equal(g1.utg.aw, g2.utg.aw)
    assert np.array_equal(np.asarray(g1.utg.acov), np.asarray(g2.utg.acov))


def test_devcount_mixed_format_discard(tmp_path, monkeypatch, reads):
    """A mixed FASTA/FASTQ buffer makes the optimistic '\\n>' split
    unsafe: the loader must invalidate the discarded attempt's device
    key lanes and return None cleanly under device counting."""
    from oatk_tpu import native
    from oatk_tpu.asm import reads as R

    if not native.available():
        pytest.skip("native library unavailable")
    mixed = tmp_path / "m.fa"
    with open(mixed, "w") as f:
        for i, r in enumerate(reads[:12]):
            f.write(f">r{i}\n{r}\n")
        f.write(f"@q0\n{reads[12]}\n+\n{'I' * len(reads[12])}\n")
    monkeypatch.setattr(R, "_SEG_BYTES", 2048)
    assert R.load_and_extract(
        [str(mixed)], W, S, device_count=True
    ) is None
