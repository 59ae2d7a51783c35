"""The plain-XLA closed-syncmer selection (kernels/syncmer.select_syncmers)
and the extractors built on it vs the sequential oracle."""
import numpy as np
import pytest

from conftest import random_read
from oatk_tpu.io.fastx import SeqRecord


def _mk(seqs):
    return [SeqRecord(i, f"r{i}", np.frombuffer(s.encode(), np.uint8)) for i, s in enumerate(seqs)]


def _assert_flat_matches_oracle(out, recs, w, s, L):
    from oatk_tpu.kernels.oracle import syncmers_of_read_oracle

    n_sel = int(out["n_sel"])
    sel_b = np.asarray(out["sel_b"])[:n_sel]
    sel_p = np.asarray(out["sel_p"])[:n_sel]
    sel_z = np.asarray(out["sel_z"])[:n_sel]
    sel_smer = np.asarray(out["sel_smer"])[:n_sel].astype(np.uint64)
    sel_kh = np.asarray(out["sel_khash"])[:n_sel]
    cuts = np.searchsorted(sel_b, np.arange(len(recs) + 1))
    for i, rec in enumerate(recs):
        ora = syncmers_of_read_oracle(rec.seq[:L], w, s, i)
        lo, hi = cuts[i], cuts[i + 1]
        np.testing.assert_array_equal(
            sel_p[lo:hi] * 2 + sel_z[lo:hi], ora.m_pos, err_msg=f"read {i} m_pos"
        )
        np.testing.assert_array_equal(sel_smer[lo:hi], ora.s_mer, err_msg=f"read {i} s_mer")
        np.testing.assert_array_equal(sel_kh[lo:hi], ora.k_mer, err_msg=f"read {i} k_mer")


@pytest.mark.parametrize("w,s", [(15, 5), (51, 11), (91, 13)])
def test_ascii_path_matches_oracle(rng, w, s):
    """Raw-ASCII extractor (device hoco phase + selection) vs oracle."""
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer import extract_syncmers_batch

    seqs = [random_read(rng, rng.integers(w + 5, 700), n_prob=0.01) for _ in range(6)]
    recs = _mk(seqs)
    B = len(recs)
    L = 1024
    seq = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(recs):
        b = r.seq[:L]
        seq[i, : len(b)] = b
        lens[i] = len(b)
    out = extract_syncmers_batch(jnp.asarray(seq), jnp.asarray(lens), w, s, 2048)
    _assert_flat_matches_oracle(out, recs, w, s, L)


@pytest.mark.parametrize("w,s", [(51, 11)])
def test_extract_all_packed_path(rng, w, s):
    """extract_all_syncmers (host hoco + 2-bit packed blob upload) vs oracle."""
    from oatk_tpu.asm.reads import extract_all_syncmers
    from oatk_tpu.kernels.oracle import syncmers_of_read_oracle

    seqs = [random_read(rng, rng.integers(w + 5, 600), n_prob=0.01) for _ in range(5)]
    recs = _mk(seqs)
    db = extract_all_syncmers(recs, w, s)
    for rec in recs:
        ora = syncmers_of_read_oracle(rec.seq, w, s, rec.sid)
        got = db.reads[rec.sid]
        np.testing.assert_array_equal(got.m_pos, ora.m_pos)
        np.testing.assert_array_equal(got.s_mer, ora.s_mer)
        np.testing.assert_array_equal(got.k_mer, ora.k_mer)


def _no_hp(rng, n):
    """Random ASCII read with no two equal neighbours (hoco length n)."""
    out = [int(rng.integers(4))]
    for _ in range(n - 1):
        out.append((out[-1] + 1 + int(rng.integers(3))) % 4)
    return "".join("ACGT"[c] for c in out)


def _with_n(seq, positions):
    a = list(seq)
    for p in positions:
        a[p] = "N"
    return "".join(a)


def _edge_reads(case, rng, w, L):
    """Reads for one edge case; every read's hoco fits in L columns."""
    if case == "n_at_window_edges":
        base = _no_hp(rng, 3 * w)
        # an N just inside, on, and just past the edges of k-mer windows
        offs = [0, 1, w - 2, w - 1, w, w + 1, 3 * w - 1]
        return [_with_n(base, [o]) for o in offs] + [_with_n(base, [w - 1, w])]
    if case == "length_k_and_k_plus_1":
        return [_no_hp(rng, n) for n in (w - 1, w, w, w + 1, w + 1, w + 2)]
    if case == "homopolymer_only":
        return ["A" * 3 * w, "C" * 40 + "G" * 40, "T", "N" * w + "A" * w, "AAAA"]
    if case == "padding_past_hoco_l":
        # one read fills its row exactly, the others leave long padding
        return [_no_hp(rng, L), _no_hp(rng, w + 3), _no_hp(rng, L - 1),
                random_read(rng, w + 40, hp_prob=0.3)]
    if case == "random_hp_and_n":
        return [random_read(rng, int(rng.integers(w, 2 * w)), hp_prob=0.2, n_prob=0.003)
                for _ in range(6)]
    raise ValueError(case)


_CASES = ["n_at_window_edges", "length_k_and_k_plus_1", "homopolymer_only",
          "padding_past_hoco_l", "random_hp_and_n"]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("w,s,L", [(1001, 31, 4096), (31, 7, 128)],
                         ids=["k1001", "k31"])
def test_select_syncmers_edge_cases(case, w, s, L):
    """select_syncmers on hoco codes: selected positions equal the
    oracle's, and the selection's details (strand, s-mer, k-mer hash)
    through extract_hoco_batch equal the oracle's too."""
    import jax.numpy as jnp

    from oatk_tpu.kernels.oracle import hoco_compress_np, syncmers_of_read_oracle
    from oatk_tpu.kernels.syncmer import extract_hoco_batch, select_syncmers

    rng = np.random.default_rng(1000 * _CASES.index(case) + w)
    recs = _mk(_edge_reads(case, rng, w, L))
    B = 8  # fixed batch: one compiled shape per (w, s, L)
    codes = np.full((B, L), 5, np.uint8)
    for i, rec in enumerate(recs):
        code, _, is_n = hoco_compress_np(rec.seq)
        assert len(code) <= L
        row = code.copy()
        row[is_n] = 4
        codes[i, : len(row)] = row
    sel = np.asarray(select_syncmers(jnp.asarray(codes), w, s))
    assert not sel[len(recs):].any()
    for i, rec in enumerate(recs):
        ora = syncmers_of_read_oracle(rec.seq, w, s, i)
        np.testing.assert_array_equal(
            np.flatnonzero(sel[i]), ora.m_pos >> 1, err_msg=f"{case} read {i}"
        )
    out = extract_hoco_batch(jnp.asarray(codes), w, s, 4096)
    _assert_flat_matches_oracle(out, recs, w, s, L)


def test_compact_sel_overflow_escalation():
    """Pathologically dense selection (>maxper per 512-subrow) must
    inflate the reported n_sel past max_out so the loader's retry
    re-dispatches with a larger max_out, which widens maxper until the
    result is exact (kernels/syncmer._compact_sel)."""
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer import _compact_sel

    rng = np.random.default_rng(11)
    B, L = 8, 2048
    sel = np.zeros((B, L), np.int32)
    # one ultra-dense subrow (200 of 512) + normal sparse elsewhere
    dense = rng.choice(512, 200, replace=False)
    sel[2, 512 + dense] = 1 + (dense % 2)
    sparse = rng.choice(L, 20, replace=False)
    sel[5, sparse] = 1
    expect = np.flatnonzero(sel.reshape(-1))
    exp_oc = sel.reshape(-1)[expect]

    max_out = 256
    for _ in range(8):  # mirrors _grow_if_overflow's loop
        fi, oc, valid, n_sel, n_rep = (
            np.asarray(x) for x in _compact_sel(jnp.asarray(sel), max_out)
        )
        if int(n_rep) <= max_out:
            break
        max_out = -(-(int(n_rep) + 1024) // 1024) * 1024
    assert int(n_sel) == len(expect)
    assert int(n_rep) == int(n_sel), "converged report must be exact"
    got = fi[valid]
    assert np.array_equal(got, expect)
    assert np.array_equal(oc[valid], exp_oc)
