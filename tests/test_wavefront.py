"""Wavefront edit distance vs reference levdist test binary + stepwise
restart property."""
import subprocess

import numpy as np
import pytest

from oatk_tpu.kernels.wavefront import WfState, wf_ed, wf_ed_core

LEVTEST = "/root/refbin/levtest"


def _ref_ed(ts: str, qs: str, is_ext: int):
    out = subprocess.run(
        [LEVTEST, ts, qs, str(is_ext)], capture_output=True, text=True
    ).stdout
    for line in out.splitlines():
        if "ED=" in line:
            parts = dict(p.split("=") for p in line.split("] ")[1].split())
            return int(parts["ED"]), int(parts["t_EN"]), int(parts["q_EN"])
    raise RuntimeError(out)


def _rand_pair(rng, tl, ql, mut=0.1):
    t = rng.choice(list("ACGT"), size=tl)
    q = list(t[: min(tl, ql)])
    # mutate
    q = [c if rng.random() > mut else "ACGT"[rng.integers(4)] for c in q]
    while len(q) < ql:
        q.append("ACGT"[rng.integers(4)])
    return "".join(t), "".join(q[:ql])


@pytest.mark.parametrize("is_ext", [0, 1])
def test_vs_reference(rng, is_ext):
    for _ in range(25):
        tl = int(rng.integers(5, 200))
        ql = int(rng.integers(5, 200))
        ts, qs = _rand_pair(rng, tl, ql)
        ref = _ref_ed(ts, qs, is_ext)
        mine = wf_ed(np.frombuffer(ts.encode(), np.uint8), np.frombuffer(qs.encode(), np.uint8), is_ext=bool(is_ext))
        assert mine == ref, (ts, qs, is_ext, mine, ref)


def test_stepwise_restart(rng):
    """Growing the query between wf_ed_core calls must give identical
    results to one-shot alignment (the EC DFS invariant)."""
    for _ in range(20):
        ts, qs = _rand_pair(rng, int(rng.integers(50, 300)), int(rng.integers(50, 300)), 0.15)
        tsb = np.frombuffer(ts.encode(), np.uint8)
        qsb = np.frombuffer(qs.encode(), np.uint8)
        ref = wf_ed(tsb, qsb, is_ext=True)
        st = WfState()
        st.reset(tsb)
        st.is_ext = True
        st.bw = -1
        pos = 0
        while pos < len(qsb):
            pos = min(len(qsb), pos + int(rng.integers(1, 60)))
            st.qs = qsb[:pos]
            wf_ed_core(st)
        assert (st.score, st.t_end, st.q_end) == ref


def test_banded(rng):
    # bw exceeded -> score > bw and zero ends
    ts = "A" * 50
    qs = "C" * 50
    score, t_end, q_end = wf_ed(
        np.frombuffer(ts.encode(), np.uint8), np.frombuffer(qs.encode(), np.uint8), True, bw=5
    )
    assert score > 5 and t_end == 0 and q_end == 0


def test_cigar_traceback_vs_reference(rng):
    from oatk_tpu.kernels.wavefront import WfState, cigar_string, wf_ed_core, wf_traceback

    for _ in range(15):
        ts, qs = _rand_pair(rng, int(rng.integers(10, 150)), int(rng.integers(10, 150)), 0.12)
        out = subprocess.run([LEVTEST, ts, qs, "1"], capture_output=True, text=True).stdout
        ref_cigar = None
        for line in out.splitlines():
            if "CIGAR_STR" in line:
                ref_cigar = line.split(": ", 1)[1].strip()
        st = WfState()
        st.reset(np.frombuffer(ts.encode(), np.uint8))
        st.qs = np.frombuffer(qs.encode(), np.uint8)
        st.is_ext = True
        st.bw = -1
        st.tb = []
        wf_ed_core(st)
        mine = cigar_string(wf_traceback(st))
        assert mine == ref_cigar, (ts, qs, mine, ref_cigar)


def test_ec_through_pallas_backend(rng, monkeypatch):
    """Full error correction driven by the numpy wavefront core
    (OATK_TPU_WF_BACKEND=numpy path) must splice reads identically to
    the default native-C core."""
    import os
    import tempfile

    import oatk_tpu.kernels.wavefront as W
    from genome_sim import random_genome, sample_reads, write_reads
    from oatk_tpu import native
    from oatk_tpu.asm import ec as EC
    from oatk_tpu.asm.consensus import scg_consensus
    from oatk_tpu.asm.pipeline import load_reads
    from oatk_tpu.asm.scg import make_syncmer_graph
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    if not native.available():
        pytest.skip("native library unavailable")
    g = random_genome(rng, 9000)
    reads = sample_reads(rng, g, coverage=10, read_len=1600, err_rate=0.003)
    td = tempfile.mkdtemp()
    fa = os.path.join(td, "r.fa")
    write_reads(fa, reads)

    def run(backend):
        rd = load_reads([fa], 151, 13, 0, True)
        scm = collect_syncmer_db(rd)
        scg = make_syncmer_graph(rd, scm, 0, 0.0)
        scg_consensus(rd, scg, hoco_seq=True, save_seq=True, fo=None)
        monkeypatch.setattr(W, "WF_BACKEND", backend)
        # force the per-read python EC loop so wf_ed_core is the engine
        monkeypatch.setattr(EC, "_correct_reads_native", lambda *a, **k: False)
        EC.read_error_correction(rd, scg, 0.02, 2, 20, 2, 0.35, 0)
        monkeypatch.undo()
        return rd

    rd_numpy = run("numpy")
    rd_default = run("auto")
    for r1, r2 in zip(rd_numpy.reads, rd_default.reads):
        assert np.array_equal(r1.k_mer, r2.k_mer)
        assert np.array_equal(r1.m_pos, r2.m_pos)


def test_native_matches_numpy(rng):
    """The C core (native/wavefront.c) must reproduce the numpy wavefront
    exactly -- score, raw endpoints, and the full (wd, wk) state -- on
    one-shot and stepwise-restart (growing query) workloads."""
    import oatk_tpu.kernels.wavefront as W
    from oatk_tpu import native
    from oatk_tpu.kernels.wavefront import _wf_ed_core_native

    if not native.available():
        pytest.skip("native library unavailable")

    def run_numpy(st):
        t = q = -1
        while True:
            na = W.wf_step(st)
            if na < 0:
                t, q = st.t_end, st.q_end
                break
            st.score += 1
            if st.bw >= 0 and st.score > st.bw:
                break
        st.t_end = t + 1
        st.q_end = q + 1

    for it in range(400):
        tl = int(rng.integers(1, 120))
        ql = int(rng.integers(1, 120))
        ts = rng.integers(0, 4, tl).astype(np.uint8)
        qs = rng.integers(0, 4, ql).astype(np.uint8)
        if rng.random() < 0.5:
            qs = ts.copy()[:ql] if ql <= tl else np.concatenate(
                [ts, rng.integers(0, 4, ql - tl).astype(np.uint8)])
            for p in rng.integers(0, len(qs), max(1, len(qs) // 20)):
                qs[p] = (qs[p] + 1) % 4
        is_ext = bool(rng.integers(2))
        bw = int(rng.choice([-1, 3, 6, 10]))
        a = WfState(); a.reset(ts); a.qs = qs; a.is_ext = is_ext; a.bw = bw
        b = WfState(); b.reset(ts); b.qs = qs; b.is_ext = is_ext; b.bw = bw
        assert _wf_ed_core_native(a)
        run_numpy(b)
        assert (a.score, a.t_end, a.q_end) == (b.score, b.t_end, b.q_end)
        assert np.array_equal(a.wd, b.wd) and np.array_equal(a.wk, b.wk)

    # stepwise restart with a growing query (the EC DFS access pattern)
    for it in range(100):
        tl = int(rng.integers(20, 150))
        ts = rng.integers(0, 4, tl).astype(np.uint8)
        full = ts.copy()
        for p in rng.integers(0, tl, 3):
            full[p] = (full[p] + 1) % 4
        a = WfState(); a.reset(ts); a.is_ext = True; a.bw = 8
        b = WfState(); b.reset(ts); b.is_ext = True; b.bw = 8
        cut = int(rng.integers(5, tl))
        for qs_piece in (full[:cut], full):
            a.qs = qs_piece; b.qs = qs_piece
            assert _wf_ed_core_native(a)
            run_numpy(b)
            assert (a.score, a.t_end, a.q_end) == (b.score, b.t_end, b.q_end)
            assert np.array_equal(a.wk, b.wk)
