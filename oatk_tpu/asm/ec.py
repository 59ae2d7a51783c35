"""Graph-path read error correction (syncerr.c analogue).

Error syncmers are marked by coverage/arc rules
(/root/reference/syncerr.c:679-757); per-read error blocks between good
anchors are corrected by DFS over graph arcs extending an incremental
wavefront edit distance (/root/reference/syncerr.c:144-668), with
band bw = max(ceil(len*max_edist), 6), DFS capped at 10000 paths, and
SUCCESS/AMBISNQ/AMBISEQ/FAILURE classification.  Winning syncmer paths
are spliced into the read (corrected mers get the ec bit and sentinel
positions), then the syncmer DB coverage is rebuilt.
"""
from __future__ import annotations

import sys

import numpy as np

from ..index.syncmer_db import SyncmerDB
from ..kernels.wavefront import WfState, wf_ed_core
from ..utils import log_info
from .reads import ReadDB
from .scg import Scg

EC_FAILURE = 0
EC_SUCCESS = 1
EC_AMBISNQ = 2
EC_AMBISEQ = 3

MAX_DFS_PATH = 10000
MIN_ERR_SEQ_LEN = 10
MIN_ERR_BASE = 6
U32_POS_MASK = 0x7FFFFFFF

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_NT = np.frombuffer(b"ACGT", np.uint8)


def find_error_syncmers(
    scg: Scg, err_mer_c: int, max_err_c: int, err_arc_c: int, max_arc_f: float, del_err: bool
) -> int:
    """Mark candidate error syncmers in scm_db.del_ (and the graph).

    Vectorized over the arc table: a direction is 'weak' when it has
    live out-arcs but none passing the coverage test (syncerr.c); the
    one-vertex-per-syncmer graph is symmetric here, so the follow-up
    vertex deletion reduces to an incidence mask."""
    g = scg.utg
    scm = scg.scm_db
    n_scm = scm.n
    g._flush_pending()
    cov = scm.cov.astype(np.int64)
    cand = ~scm.del_ & (cov < max_err_c)
    scm.del_ |= cand & (cov < err_mer_c)
    live = ~g.adel
    src = g.av.astype(np.int64)
    dst_v = (g.aw >> np.uint64(1)).astype(np.int64)
    src_v = src >> 1
    strong = live & (g.acov >= err_arc_c) & (
        g.acov >= np.minimum(cov[src_v], cov[dst_v]) * max_arc_f
    )
    n_dir = 2 * n_scm
    has_live = np.bincount(src[live], minlength=n_dir).astype(bool)
    has_strong = np.bincount(src[strong], minlength=n_dir).astype(bool)
    weak = has_live & ~has_strong
    scm.del_ |= cand & (cov >= err_mer_c) & (weak[0::2] | weak[1::2])
    n_err = int(scm.del_.sum())
    max_c = int(scm.cov[scm.del_].max()) if n_err else 0
    if del_err and n_err:
        vdel = np.asarray(g.vtx_del, bool) | scm.del_[: g.n_vtx]
        g.vtx_del = vdel  # ndarray-backed column (see Asmg.add_vtx)
        g.adel |= vdel[src_v] | vdel[dst_v]
    log_info(f"error syncmer candidates: num = {n_err}, max_c = {max_c}", func="find_error_syncmers")
    return n_err


class _DfsInfo:
    def __init__(self):
        self.reset()

    def reset(self):
        self.status = EC_FAILURE
        self.n_path = 0
        self.edist = 1 << 30
        self.s_edist = 1 << 30
        self.c_seq = bytearray()
        self.opt_seq = b""
        self.c_path: list[int] = []
        self.opt_path: list[int] = []


def _dfs_search(g, dfs: _DfsInfo, sink: int, conf: WfState):
    if dfs.n_path >= MAX_DFS_PATH:
        return
    c_seq = dfs.c_seq
    l0 = len(c_seq)
    c_path = dfs.c_path
    n0 = len(c_path)
    source = c_path[-1]
    snap = conf.snapshot()
    t_end0 = conf.t_end

    for ai in g.arc_range(source):
        if g.adel[ai]:
            continue
        w = int(g.aw[ai])
        ls = int(g.als[ai])
        k_seq = g.vtx_seq[w >> 1]
        l_seq = g.vtx_len[w >> 1]

        c_path.append(w)
        if w & 1:
            c_seq.extend(k_seq[: l_seq - ls].encode().translate(_COMP)[::-1])
        else:
            c_seq.extend(k_seq[ls:].encode())

        conf.qs = np.frombuffer(bytes(c_seq), np.uint8)
        wf_ed_core(conf)

        score = conf.score + len(conf.ts) - conf.t_end
        if score <= conf.bw and (sink == -1 or sink == w):
            dfs.status = EC_SUCCESS
            if score <= dfs.edist:
                if conf.t_end > t_end0:
                    dfs.s_edist = dfs.edist
                dfs.edist = score
                if sink == -1 and conf.q_end < len(conf.qs):
                    c_path.pop()
                if dfs.edist == dfs.s_edist:
                    if conf.q_end != len(dfs.opt_seq) or bytes(
                        c_seq[: conf.q_end]
                    ) != dfs.opt_seq[: conf.q_end]:
                        dfs.status = EC_AMBISEQ
                    if dfs.status == EC_SUCCESS and c_path != dfs.opt_path:
                        dfs.status = EC_AMBISNQ
                dfs.opt_seq = bytes(c_seq[: conf.q_end])
                dfs.opt_path = list(c_path)
            elif score < dfs.s_edist:
                dfs.s_edist = score

        if (
            conf.score <= conf.bw
            and len(conf.qs) - l_seq <= len(conf.ts) + conf.bw
            and ((sink != -1 and sink != w) or conf.t_end < len(conf.ts))
        ):
            _dfs_search(g, dfs, sink, conf)
        else:
            dfs.n_path += 1

        del c_path[n0:]
        del c_seq[l0:]
        conf.restore(snap)


def _ec_path_search(g, source: int, sink: int, conf: WfState, dfs: _DfsInfo) -> int:
    if len(conf.ts) < 0:
        return 0
    dfs.reset()
    dfs.c_path.append(source)
    _dfs_search(g, dfs, sink, conf)
    return dfs.status


def _hoco_dna(read, pos: int, l: int, rev: int) -> np.ndarray:
    win = read.hoco_code[pos : pos + l].astype(np.int64)
    if rev:
        win = (3 - win)[::-1]
    return _NT[win]


def _correct_read(read, scg: Scg, max_edist: float, stats: np.ndarray, conf: WfState, dfs: _DfsInfo):
    g = scg.utg
    scm_del = scg.scm_db.del_
    w = scg_kmer_size = _kmer_size(scg)
    k_mer = read.k_mer
    m_pos = read.m_pos
    n_scm = read.n

    c_kmer: list[int] = []
    c_mpos: list[int] = []
    updated = True
    beg = -1
    while True:
        beg_pos = 0 if beg < 1 else (int(m_pos[beg - 1]) >> 1) + w
        beg_pos += MIN_ERR_SEQ_LEN
        end = beg + 1
        while end < n_scm:
            km = int(k_mer[end])
            if not scm_del[km >> 1] and not (km & 1) and (int(m_pos[end]) >> 1) >= beg_pos:
                break
            end += 1

        if beg >= 0 or end < n_scm:
            if beg < 0:
                beg = end  # good syncmer
                beg_utg = (int(k_mer[beg]) & ~1) | (0 if (int(m_pos[beg]) & 1) else 1)
                beg_pos = 0
                end_utg = -1
                l = int(m_pos[beg]) >> 1
                r = 1
            else:
                beg -= 1  # good syncmer
                beg_utg = (int(k_mer[beg]) & ~1) | (int(m_pos[beg]) & 1)
                beg_pos = (int(m_pos[beg]) >> 1) + w
                if end >= n_scm:
                    end_utg = -1
                    l = read.hoco_l - beg_pos
                else:
                    end_utg = (int(k_mer[end]) & ~1) | (int(m_pos[end]) & 1)
                    l = (int(m_pos[end]) >> 1) - beg_pos
                r = 0

            assert l >= 0
            if l >= MIN_ERR_SEQ_LEN:
                conf.reset(_hoco_dna(read, beg_pos, l, r))
                conf.is_ext = True
                conf.bw = max(int(np.ceil(l * max_edist)), MIN_ERR_BASE)
                err_c1 = _ec_path_search(g, beg_utg, end_utg, conf, dfs)
                if end_utg == -1:
                    stats[0] += 1
                    stats[1 + err_c1] += 1
                else:
                    stats[5] += 1
                    stats[6 + err_c1] += 1
            else:
                err_c1 = EC_FAILURE
                stats[10] += 1

            if err_c1 == EC_SUCCESS:
                n = len(dfs.opt_path)
                if r:
                    for j in range(n - 1, 0, -1):
                        c_kmer.append((dfs.opt_path[j] & ~1) | 1)
                        c_mpos.append(0xFFFFFFFF ^ (dfs.opt_path[j] & 1))
                else:
                    for j in range(1, n - 1):
                        c_kmer.append((dfs.opt_path[j] & ~1) | 1)
                        c_mpos.append(0xFFFFFFFE | (dfs.opt_path[j] & 1))
                    if end_utg == -1 and n > 1:
                        c_kmer.append((dfs.opt_path[n - 1] & ~1) | 1)
                        c_mpos.append(0xFFFFFFFE | (dfs.opt_path[n - 1] & 1))
            else:
                if r:
                    c_kmer.extend(int(x) for x in k_mer[:beg])
                    c_mpos.extend(int(x) for x in m_pos[:beg])
                elif beg + 1 < n_scm:
                    c_kmer.extend(int(x) for x in k_mer[beg + 1 : end])
                    c_mpos.extend(int(x) for x in m_pos[beg + 1 : end])
        else:
            updated = False

        # next bad syncmer (faithful to reference's k_mer[end] check)
        beg = end + 1
        while beg < n_scm:
            if scm_del[int(k_mer[beg]) >> 1] or (int(k_mer[end]) & 1):
                break
            beg += 1
        if beg > n_scm:
            break
        c_kmer.extend(int(x) for x in k_mer[end:beg])
        c_mpos.extend(int(x) for x in m_pos[end:beg])

    if updated:
        read.k_mer = np.array(c_kmer, np.uint64)
        read.m_pos = np.array(c_mpos, np.uint32)
        read.s_mer = np.array(
            [scg.scm_db.s[x >> 1] for x in c_kmer], np.uint64
        ) if c_kmer else np.zeros(0, np.uint64)


def _kmer_size(scg) -> int:
    return scg._kmer_size


def _correct_reads_native(
    read_db: ReadDB, scg: Scg, max_edist: float, stats: np.ndarray,
    ranges: list[tuple[int, int]] | None = None, gather=None,
) -> bool:
    """Run the batched C corrector (native/ec.c); returns False when
    unavailable so the caller uses the Python loop.

    ranges: contiguous read ranges to correct locally (P3 data
    parallelism over the mesh/processes, /root/reference/syncerr.c:882);
    ``gather`` turns the local parts into the full-ordered part list
    (cross-process allgather).  Per-read corrections are independent
    (the graph is read-only during EC), so the merged splice is
    bit-identical to an unsharded run."""
    from .. import native
    from ..kernels import wavefront as _wf

    # an explicit wavefront backend (numpy) must actually
    # drive EC: route through the Python loop + wf_ed_core
    cap = _wf.WF_BACKEND == "auto" and native.available()
    if gather is not None:
        # cross-process: agree on capability BEFORE any data collective
        # so one incapable rank sends ALL ranks to the replicated
        # Python fallback instead of deadlocking the others' allgather
        from ..dist.stages import all_ranks_ok

        cap = all_ranks_ok(cap)
    if not cap:
        return False
    g = scg.utg
    g._flush_pending()
    n_vtx = g.n_vtx
    lz = getattr(g, "_seq_lazy", None)
    lazy_src = lazy_rev = lazy_codes = None
    buf = getattr(g, "_seq_buf", None)
    cuts = getattr(g, "_seq_cuts", None)
    if lz is not None and len(lz[1]) == n_vtx:
        # lazy consensus: native EC decodes vertex windows straight from
        # the hoco code stream (no materialized ASCII buffer at all)
        lazy_codes, lazy_src, lazy_rev = lz[0], lz[1], lz[2]
        seq_flat = np.zeros(0, np.uint8)
        seq_off = np.zeros(n_vtx + 1, np.int64)
    elif buf is not None and cuts is not None and len(cuts) == n_vtx + 1:
        # consensus pass cached its raw emission buffer: no str round trip
        seq_flat = buf
        seq_off = cuts
    else:
        seqs = [g.vtx_seq[i] or "" for i in range(n_vtx)]
        seq_off = np.zeros(n_vtx + 1, np.int64)
        np.cumsum(np.fromiter((len(s) for s in seqs), np.int64, count=n_vtx), out=seq_off[1:])
        seq_flat = np.frombuffer("".join(seqs).encode(), np.uint8)

    reads = read_db.reads
    n_reads = len(reads)
    hoco_l = np.fromiter((r.hoco_l for r in reads), np.int64, count=n_reads)
    from .consensus import _Flats

    flats = _Flats.build(read_db, scg.scm_db)
    if flats is not None:
        # the consensus pass running just before EC caches exactly these
        # concatenations; reuse instead of re-materializing them
        kflat, mflat = flats.kflat, flats.mflat
        code_flat = flats.code_flat
        moff = np.append(flats.moff, len(kflat))
        hoff = np.append(flats.hoff, len(code_flat))
    else:
        moff = np.zeros(n_reads + 1, np.int64)
        np.cumsum(np.fromiter((len(r.m_pos) for r in reads), np.int64, count=n_reads), out=moff[1:])
        hoff = np.zeros(n_reads + 1, np.int64)
        np.cumsum(hoco_l, out=hoff[1:])
        z64, z32, z8 = np.zeros(0, np.uint64), np.zeros(0, np.uint32), np.zeros(0, np.uint8)
        kflat = np.concatenate([r.k_mer for r in reads]).astype(np.uint64, copy=False) if n_reads else z64
        mflat = np.concatenate([r.m_pos for r in reads]).astype(np.uint32, copy=False) if n_reads else z32
        code_flat = (
            np.concatenate([r.hoco_code for r in reads]).astype(np.uint8, copy=False) if n_reads else z8
        )

    g_args = (
        np.ascontiguousarray(g.idx_p, np.int64),
        np.ascontiguousarray(g.idx_n, np.int64),
        np.ascontiguousarray(g.aw, np.uint64),
        np.ascontiguousarray(g.als, np.int64),
        np.ascontiguousarray(g.adel, np.uint8),
        seq_flat, seq_off,
        np.ascontiguousarray(g.vtx_len, np.int64),
        np.ascontiguousarray(scg.scm_db.del_, np.uint8),
    )

    def run_range(lo: int, hi: int):
        if lo == 0 and hi == n_reads:
            k_s, m_s, moff_s = kflat, mflat, moff
            c_s, hoff_s, hl_s = code_flat, hoff, hoco_l
        else:
            k_s = kflat[moff[lo] : moff[hi]]
            m_s = mflat[moff[lo] : moff[hi]]
            moff_s = moff[lo : hi + 1] - moff[lo]
            c_s = code_flat[hoff[lo] : hoff[hi]]
            hoff_s = hoff[lo : hi + 1] - hoff[lo]
            hl_s = hoco_l[lo:hi]
        return native.ec_correct_reads(
            *g_args,
            np.ascontiguousarray(k_s), np.ascontiguousarray(m_s),
            np.ascontiguousarray(moff_s), np.ascontiguousarray(c_s),
            np.ascontiguousarray(hoff_s), np.ascontiguousarray(hl_s),
            read_db.k, max_edist,
            lazy_src=lazy_src, lazy_rev=lazy_rev, lazy_codes=lazy_codes,
        )

    if ranges is None:
        ranges = [(0, n_reads)]
    parts = []
    failed = False
    for lo, hi in ranges:
        res = run_range(lo, hi)
        if res is None:
            failed = True
            break
        parts.append(res)
    if gather is not None:
        # second agreement: a data-dependent failure (allocation /
        # wavefront overflow) on one rank must not skip the collective
        from ..dist.stages import all_ranks_ok

        if not all_ranks_ok(not failed):
            return False
    if failed:
        return False
    if gather is not None:
        import os as _os
        import time as _time

        _g0 = _time.perf_counter()
        parts = gather(parts)
        if _os.environ.get("OATK_TPU_TIMEIT"):
            import sys as _sys

            print(
                f"[T::dist] ec_gather={(_time.perf_counter() - _g0) * 1000:.1f}ms",
                file=_sys.stderr, flush=True,
            )
    if len(parts) == 1:
        st, out_kmer, out_mpos, out_cut, out_upd = parts[0]
    else:
        st = parts[0][0].copy()
        for p in parts[1:]:
            st = st + p[0]
        out_kmer = np.concatenate([p[1] for p in parts])
        out_mpos = np.concatenate([p[2] for p in parts])
        out_upd = np.concatenate([p[4] for p in parts])
        cut_l = [np.zeros(1, np.int64)]
        base = 0
        for p in parts:
            cut_l.append(p[3][1:] + base)
            base += int(p[3][-1])
        out_cut = np.concatenate(cut_l)
    stats += st
    from .consensus import set_read_flats

    cached = getattr(read_db, "_rflats_cache", None)
    old_rf = (
        cached[1]
        if cached is not None and cached[0] == getattr(read_db, "version", 0)
        else None
    )
    smer_all = scg.scm_db.s[(out_kmer >> np.uint64(1)).astype(np.int64)]
    for r_i, r in enumerate(reads):
        if not out_upd[r_i]:
            continue
        lo, hi = int(out_cut[r_i]), int(out_cut[r_i + 1])
        # views: per-read syncmer arrays are never written in place
        r.k_mer = out_kmer[lo:hi]
        r.m_pos = out_mpos[lo:hi]
        r.s_mer = smer_all[lo:hi]
    read_db.version += 1
    if old_rf is not None:
        # merge corrected spans into fresh whole-run flats and register
        # them under the bumped version: update_syncmer_db and the
        # post-EC stat pass then skip their per-read rebuilds
        upd = out_upd.view(bool) if out_upd.dtype == np.uint8 else out_upd.astype(bool)
        nl = np.where(upd, np.diff(out_cut), old_rf.mc)
        total_new = int(nl.sum())
        noff = np.zeros(len(nl), np.int64)
        if len(nl) > 1:
            np.cumsum(nl[:-1], out=noff[1:])
        within = np.arange(total_new, dtype=np.int64) - np.repeat(noff, nl)
        src_idx = np.repeat(np.where(upd, out_cut[:-1], old_rf.moff), nl) + within
        mask = np.repeat(upd, nl)
        inv = ~mask
        new_kflat = np.empty(total_new, np.uint64)
        new_kflat[mask] = out_kmer[src_idx[mask]]
        new_kflat[inv] = old_rf.kflat[src_idx[inv]]
        new_mflat = np.empty(total_new, np.uint32)
        new_mflat[mask] = out_mpos[src_idx[mask]]
        new_mflat[inv] = old_rf.mflat[src_idx[inv]]
        new_sflat = None
        if old_rf._sflat is not None:
            new_sflat = np.empty(total_new, np.uint64)
            new_sflat[mask] = smer_all[src_idx[mask]]
            new_sflat[inv] = old_rf._sflat[src_idx[inv]]
        set_read_flats(read_db, nl, new_kflat, new_mflat, new_sflat, old_rf.sids)
    return True


def update_syncmer_db(read_db: ReadDB, scm_db: SyncmerDB):
    """Rebuild coverage and position lists after correction; syncmers
    left with no forward-strand occurrence are deleted.

    Vectorized: reads are flattened in sid order, so a stable sort by
    syncmer id yields each id's occurrence list already in the
    (sid, idx) order the per-read loop produced."""
    from .consensus import read_flats

    n = scm_db.n
    # (the correction step bumped read_db.version after splicing)
    rf = read_flats(read_db)
    n_tot = int(rf.mc.sum())
    if n_tot:
        ks = rf.kflat >> np.uint64(1)
        mflat = rf.mflat
        sid_rep = np.repeat(rf.sids.astype(np.uint64), rf.mc)
        idx = (
            np.arange(n_tot, dtype=np.uint64)
            - np.repeat(rf.moff, rf.mc).astype(np.uint64)
        )
        entry = (
            (sid_rep << np.uint64(32))
            | (idx << np.uint64(1))
            | (mflat.astype(np.uint64) & np.uint64(1))
        )
    else:
        ks = np.zeros(0, np.uint64)
        entry = np.zeros(0, np.uint64)
    kid = ks.astype(np.int64)
    cov = np.bincount(kid, minlength=n)
    fwd = (entry & np.uint64(1)) == 0
    c_cov = np.bincount(kid[fwd], minlength=n)
    from .. import native as _native

    order = _native.argsort_u64(ks)
    if order is None:
        order = np.argsort(kid, kind="stable")
    sorted_entries = entry[order]
    cuts = np.zeros(n + 1, np.int64)
    np.cumsum(cov, out=cuts[1:])
    scm_db.cov = cov.astype(np.uint32)
    from ..index.syncmer_db import FlatViews

    scm_db.m_pos = FlatViews(sorted_entries, cuts)
    scm_db.mp_flat = sorted_entries
    scm_db.mp_off = cuts
    scm_db.del_ = c_cov == 0
    scm_db.version += 1


def read_error_correction(
    read_db: ReadDB,
    scg: Scg,
    max_edist: float,
    err_mer_c: int,
    max_err_c: int,
    err_arc_c: int,
    max_arc_f: float,
    verbose: int = 0,
):
    import time

    cpu0, real0 = time.process_time(), time.time()
    sys.setrecursionlimit(1_000_000)
    scg._kmer_size = read_db.k
    find_error_syncmers(scg, err_mer_c, max_err_c, err_arc_c, max_arc_f, True)

    # cross-process read sharding (P3 over the mesh): each process
    # corrects its contiguous read range, parts allgather in rank order;
    # OATK_TPU_STAGE_SHARDS forces the partition/merge path in-process
    # (virtual-mesh validation)
    ranges = gather = None
    import os as _os

    import jax as _jax

    _k = int(_os.environ.get("OATK_TPU_STAGE_SHARDS", "0"))
    if _jax.process_count() > 1:
        from ..dist.stages import ec_gather, shard_ranges

        ranges = [shard_ranges(read_db.n, _jax.process_count())[_jax.process_index()]]
        gather = ec_gather
    elif _k > 1:
        from ..dist.stages import shard_ranges

        ranges = shard_ranges(read_db.n, _k)

    stats = np.zeros(11, np.int64)
    if not _correct_reads_native(read_db, scg, max_edist, stats, ranges, gather):
        from .consensus import ensure_vtx_seq

        ensure_vtx_seq(scg.utg)
        conf = WfState()
        dfs = _DfsInfo()
        for r in read_db.reads:
            _correct_read(r, scg, max_edist, stats, conf, dfs)
        read_db.version += 1  # reads were spliced in place

    update_syncmer_db(read_db, scg.scm_db)

    # summary table exactly as syncerr.c:905-927; note the reference
    # labels AMBISNQ (path) counts "ambiguous seqs" and vice versa --
    # the swap is kept for byte parity
    p = lambda msg: log_info(msg, func="read_error_correction")
    p("Error Correction Summary Results")
    p(f"total number of error blocks : {stats[0] + stats[5] + stats[10]}")
    p(f"               - uncorrected : {stats[1] + stats[6]}")
    p(f"                 - corrected : {stats[2] + stats[7]}")
    p(f"            - ambiguous seqs : {stats[3] + stats[8]}")
    p(f"            - ambiguous path : {stats[4] + stats[9]}")
    if verbose:
        p(f"error blocks in the tail end : {stats[0]}")
        p(f"               - uncorrected : {stats[1]}")
        p(f"                 - corrected : {stats[2]}")
        p(f"            - ambiguous seqs : {stats[3]}")
        p(f"            - ambiguous path : {stats[4]}")
        p(f"  error blocks in the middle : {stats[5]}")
        p(f"               - uncorrected : {stats[6]}")
        p(f"                 - corrected : {stats[7]}")
        p(f"            - ambiguous seqs : {stats[8]}")
        p(f"            - ambiguous path : {stats[9]}")
        p(f"     error blocks overlapped : {stats[10]}")
        p(f"  error correction  CPU time : {time.process_time() - cpu0:.3f} sec")
        p(f"  error correction real time : {time.time() - real0:.3f} sec")
