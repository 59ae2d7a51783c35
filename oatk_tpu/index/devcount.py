"""Device-resident syncmer counting for the single-chip production path.

The reference's HOT LOOP 2 is a global qsort of 128-bit
(kmerhash<<64 | sid<<32 | idx<<1 | rev) keys plus per-cluster collision
resolution (/root/reference/syncmer.c:1397-1451).  The tuned loader
(asm/reads.py) computes the Murmur hashes on device during extraction;
instead of fetching them to the host and sorting there, this module
keeps the (hash, low, smer) key triples ON DEVICE:

- every extraction chunk appends its keys into donated carry buffers
  (one small jit per chunk, overlapped with the next chunk's upload);
- finalize runs ONE device sort by (valid, hash, low) -- the exact
  total order of the reference qsort -- assigns dense syncmer ids as a
  prefix sum over cluster starts, flags hash collisions by comparing
  s-mer payloads against the cluster head, compacts the per-cluster
  head (hash, smer) pairs, and re-sorts ids back to per-read flat
  order (flat order IS ascending ``low``);
- the host fetches a u32 id per occurrence (flat order) plus the tiny
  per-distinct head arrays -- REPLACING the 8-byte khash lane of the
  per-chunk packed fetch, so fewer bytes come back and the host never
  sorts.

Hash collisions between different k-mer sequences (never observed in
practice; the reference checks only under DEBUG_CHECK_HASH_COLLISION,
syncmer.c:1336-1340) fall back to the host exact-sequence resolution
over the fetched sorted keys, byte-identical to the host path.

All jit shapes are drawn from a small vocabulary (2048-grid chunk
lanes x power-of-four buffer capacities), so a new dataset reuses
cached XLA programs.
"""
from __future__ import annotations

from functools import partial

import numpy as np

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _cap_quantum(x: int) -> int:
    """Buffer capacities snap to powers of FOUR (min 2^18): every cap
    value compiles its own write/finalize programs, so the vocabulary is
    kept to ~4 values across all dataset scales at the price of at most
    4x sort oversize."""
    c = 1 << 18
    while c < x:
        c <<= 2
    return c


def _jax():
    import jax

    return jax


def _make_keys_jit():
    """Per-chunk key decode, padded to a coarse lane grid.

    Cap-independent on purpose: its compile vocabulary is the loader's
    fixed chunk-shape set, reused across dataset scales; only the tiny
    write step below depends on the buffer capacity."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("Lp", "out_cap"))
    def keys_jit(packed, sids, Lp, out_cap):
        from jax import lax

        max_out = packed.shape[1] - 1
        B = sids.shape[0]
        n_sel = packed[0, max_out].astype(jnp.int32)
        lane = jnp.arange(max_out, dtype=jnp.int32)
        valid = lane < jnp.minimum(n_sel, max_out)

        flat = packed[0, :max_out]
        z = (flat & 1).astype(jnp.uint64)
        fi = flat >> 1
        b = (fi // Lp).astype(jnp.int32)
        # rank within read: first lane with the same row (sel rows are
        # ascending; invalid lanes map to sentinel B so they group last)
        bkey = jnp.where(valid, b, B)
        first = jnp.searchsorted(bkey, bkey).astype(jnp.int32)
        idx = (lane - first).astype(jnp.uint64)
        sid = sids[jnp.clip(b, 0, B - 1)].astype(jnp.uint64)
        low = (sid << jnp.uint64(32)) | (idx << jnp.uint64(1)) | z
        h = lax.bitcast_convert_type(packed[2, :max_out], jnp.uint64)
        sm = lax.bitcast_convert_type(packed[1, :max_out], jnp.uint64)
        # per-occurrence m_pos payload (reference sr_t: hoco_pos<<1|rev);
        # carrying it through the finalize lets the host skip the
        # per-chunk packed fetch entirely (full-fetch mode)
        m32 = (((fi % Lp) << 1) | (flat & 1)).astype(jnp.uint32)
        vinv = jnp.where(valid, 0, 1).astype(jnp.int32)

        pad = out_cap - max_out
        return (
            packed[0, max_out : max_out + 1],
            jnp.pad(h, (0, pad)),
            jnp.pad(low, (0, pad)),
            jnp.pad(sm, (0, pad)),
            jnp.pad(m32, (0, pad)),
            jnp.pad(vinv, (0, pad), constant_values=1),
        )

    return keys_jit


def _make_write_jit():
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4))
    def write_jit(bh, bl, bs, bm, bv, h, l, s, m, v, wr):
        from jax import lax

        bh = lax.dynamic_update_slice(bh, h, (wr,))
        bl = lax.dynamic_update_slice(bl, l, (wr,))
        bs = lax.dynamic_update_slice(bs, s, (wr,))
        bm = lax.dynamic_update_slice(bm, m, (wr,))
        bv = lax.dynamic_update_slice(bv, v, (wr,))
        return bh, bl, bs, bm, bv

    return write_jit


def _make_invalidate_jit():
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, donate_argnums=(0,))
    def invalidate_jit(bv, off, n):
        i = jnp.arange(bv.shape[0], dtype=jnp.int64)
        return jnp.where((i >= off) & (i < off + n), jnp.int32(1), bv)

    return invalidate_jit


def _make_grow_jit():
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("new_cap",), donate_argnums=(0, 1, 2, 3, 4))
    def grow_jit(bh, bl, bs, bm, bv, new_cap):
        pad = new_cap - bh.shape[0]
        return (
            jnp.pad(bh, (0, pad)),
            jnp.pad(bl, (0, pad)),
            jnp.pad(bs, (0, pad)),
            jnp.pad(bm, (0, pad)),
            jnp.pad(bv, (0, pad), constant_values=1),
        )

    return grow_jit


def _make_finalize_jit():
    import jax
    import jax.numpy as jnp

    # no donation: the carry buffers stay alive so a (rare) overflow
    # regrow discovered AFTER the early finalize dispatch can invalidate
    # + re-append and re-dispatch; XLA wasn't aliasing these anyway
    # (5 u64 outputs vs 3 u64 inputs)
    @jax.jit
    def finalize_jit(bh, bl, bs, bm, bv):
        from jax import lax

        cap = bh.shape[0]
        i = jnp.arange(cap, dtype=jnp.int32)
        # the reference's total 128-bit key order: (hash, low) over the
        # valid lanes; invalid lanes (vinv=1) sort to the tail.  This is
        # the ONLY sort: ids are a prefix sum over cluster starts, the
        # head tables compact with a scatter by id, and the sorted low
        # keys double as the position lists (mp_flat) on the host.
        vv, h1, l1, s1, m1 = lax.sort((bv, bh, bl, bs, bm), num_keys=3)
        valid = vv == 0
        n_tot = jnp.sum(valid, dtype=jnp.int32)

        prev_h = jnp.concatenate([h1[:1] ^ jnp.uint64(1), h1[:-1]])
        f = valid & ((i == 0) | (h1 != prev_h))
        gid = jnp.cumsum(f.astype(jnp.int32)) - 1
        n_scm = jnp.sum(f, dtype=jnp.int32)

        head = lax.cummax(jnp.where(f, i, -1))
        s_head = s1[jnp.maximum(head, 0)]
        n_susp = jnp.sum(valid & (s1 != s_head), dtype=jnp.int32)

        # per-cluster head (hash, smer) compacted to [0, n_scm) in gid
        # order: a stable single-key sort (a deterministic compaction
        # with no scatter)
        nf = jnp.where(f, 0, 1).astype(jnp.int32)
        _, hh, hs = lax.sort((nf, h1, s1), num_keys=1, is_stable=True)

        # everything per-occurrence back to per-read flat order
        # (= ascending low): the host fetches ids + m_pos from HERE
        # instead of draining every chunk's padded packed result --
        # exact bytes, one transfer (full-fetch mode).  The smer payload
        # does NOT ride along: n_susp above counts exactly the lanes
        # where s1 != cluster head, so when it is zero every
        # occurrence's s_mer equals hs[gid] and the host reconstructs it
        # from the (much smaller) head table.
        vf, lf, gid_flat, m32_flat = lax.sort((vv, l1, gid, m1), num_keys=2)

        # per-read occurrence counts: compact (sid, flat_start) at read
        # boundaries; the host turns consecutive starts into mc slices
        sidf = lf >> jnp.uint64(32)
        fr = (vf == 0) & (
            (i == 0) | (sidf != jnp.concatenate([sidf[:1], sidf[:-1]]))
        )
        n_ru = jnp.sum(fr, dtype=jnp.int32)
        nfr = jnp.where(fr, 0, 1).astype(jnp.int32)
        _, rs_sid, rs_pos = lax.sort((nfr, sidf, i), num_keys=1, is_stable=True)

        # ---- arc-pair counting (make_syncmer_graph HOT input) ----
        # The graph builder's arc counts are a sort-reduce over all
        # consecutive-syncmer pairs per read (/root/reference/
        # syncasm.c:231-257); in flat (sid, idx) order those pairs are
        # exactly the adjacent lane pairs within one sid.  Counting them
        # here reuses the buffers already on device and overlaps the
        # host read assembly, removing the host-side pair materialize +
        # radix sort (~0.8 s/Gbp) from ec_graph0 / make_graph.
        # INVARIANT: gid is int32 (< 2^31), so v = gid<<1|rev fits 32
        # bits and the 32/32 pair packing below cannot collide.  The
        # host consumer (asm/scg.py device-pairs branch) hardcodes
        # hi=1<<31 on the same invariant; widening gid beyond int32
        # requires changing BOTH sites.
        one = jnp.uint64(1)
        gidu = jnp.maximum(gid_flat, 0).astype(jnp.uint64)
        v = (gidu << one) | (lf & one)
        pok = (vf[:-1] == 0) & (vf[1:] == 0) & (sidf[:-1] == sidf[1:])
        v0, v1 = v[:-1], v[1:]
        flip = v0 > v1
        cv0 = jnp.where(flip, v1 ^ one, v0)
        cv1 = jnp.where(flip, v0 ^ one, v1)
        pkey = jnp.where(pok, (cv0 << jnp.uint64(32)) | cv1, U64_MAX)
        pkey = jnp.pad(pkey, (0, 1), constant_values=U64_MAX)
        pks = lax.sort(pkey)
        pvalid = pks != U64_MAX
        n_pv = jnp.sum(pvalid, dtype=jnp.int32)
        pf = pvalid & ((i == 0) | (pks != jnp.concatenate([pks[:1], pks[:-1]])))
        n_pu = jnp.sum(pf, dtype=jnp.int32)
        # compact unique pair keys + their start positions; counts are
        # consecutive-start differences (last unique runs to n_pv)
        npf = jnp.where(pf, 0, 1).astype(jnp.int32)
        _, pk_u, pos_u = lax.sort((npf, pks, i), num_keys=1, is_stable=True)
        nxt = jnp.concatenate([pos_u[1:], pos_u[:1]])
        pcnt = jnp.where(i == n_pu - 1, n_pv - pos_u, nxt - pos_u)

        scalars = jnp.stack([n_tot, n_scm, n_susp, n_pu, n_ru])
        return (gid_flat, m32_flat, rs_sid, rs_pos, hh, hs,
                h1, l1, s1, scalars, pk_u, pcnt)

    return finalize_jit


_append = None
_invalidate = None
_grow = None
_finalize = None


def _jits():
    global _append, _invalidate, _grow, _finalize
    if _append is None:
        _append = (_make_keys_jit(), _make_write_jit())
        _invalidate = _make_invalidate_jit()
        _grow = _make_grow_jit()
        _finalize = _make_finalize_jit()
    return _append, _invalidate, _grow, _finalize


class DevCountState:
    """Device carry buffers accumulating (hash, low, smer) key lanes
    across extraction chunks; finalize builds the SyncmerDB."""

    def __init__(self, cap_hint: int = 0):
        self._bufs = None  # (bh, bl, bs, bm, bv) device arrays
        self._final = None  # pre-dispatched finalize outputs
        self._prefetch = None  # (n_reads, m, mr, tree) async host copies
        self.cap = 0
        self.cap_hint = cap_hint  # expected total lanes (avoids growth
        # steps, each of which compiles a fresh (max_out, cap) append)
        self.n_fill = 0  # host-tracked append offset
        self.n_occ = 0  # loader-tracked true occurrence count (sum of
        # per-chunk n_sel scalars): sizes the finalize fetch and cross
        # checks the device sort's own count
        # evidence counters (at-scale validation):
        # buffer growth steps, chunk appends, overflow invalidations
        self.n_grow = 0
        self.n_append = 0
        self.n_invalidate = 0

    def _ensure(self, need: int):
        import jax.numpy as jnp

        append, invalidate, grow, finalize = _jits()
        if self._bufs is None:
            self.cap = _cap_quantum(max(need, self.cap_hint))
            self._bufs = (
                jnp.full(self.cap, U64_MAX, jnp.uint64),
                jnp.full(self.cap, U64_MAX, jnp.uint64),
                jnp.full(self.cap, U64_MAX, jnp.uint64),
                jnp.zeros(self.cap, jnp.uint32),
                jnp.ones(self.cap, jnp.int32),
            )
        while self.n_fill + need > self.cap:
            new_cap = self.cap << 2  # stay on the pow4 quantum grid
            self._bufs = grow(*self._bufs, new_cap=new_cap)
            self.cap = new_cap
            self.n_grow += 1

    def append(self, packed, sids: np.ndarray, Lp: int, max_out: int):
        """Append one chunk's keys; returns (n_sel device scalar slice
        [1] -- the only per-chunk fetch left -- and the chunk offset in
        the buffers)."""
        import jax.numpy as jnp

        self._final = None  # stale if finalize was dispatched early
        self._prefetch = None
        (keys, write), *_ = _jits()
        # chunk lanes snap to a 2048 grid: the key decode stays within
        # the loader's chunk-shape compile vocabulary, the write step
        # compiles per (lane grid, cap) only
        out_cap = -(-max_out // 2048) * 2048
        self._ensure(out_cap)
        off = self.n_fill
        nsel, h, l, s, m, v = keys(
            packed, jnp.asarray(sids, jnp.int64), Lp=Lp, out_cap=out_cap
        )
        self._bufs = write(*self._bufs, h, l, s, m, v, np.int32(off))
        self.n_fill = off + out_cap
        self.n_append += 1
        return nsel, off

    def invalidate(self, off: int, n: int):
        """Mark a previously appended chunk's lanes invalid (overflow
        regrow or a discarded parse attempt)."""
        if self._bufs is None:
            return
        self._final = None  # stale if finalize was dispatched early
        self._prefetch = None
        _, invalidate, *_ = _jits()
        bh, bl, bs, bm, bv = self._bufs
        bv = invalidate(bv, np.int64(off), np.int64(n))
        self._bufs = (bh, bl, bs, bm, bv)
        self.n_invalidate += 1

    def start_finalize(self):
        """Dispatch the finalize sort (async); the loader calls this as
        soon as the last chunk is appended so the device sort overlaps
        the host-side read assembly.  The carry buffers stay alive: a
        later append/invalidate (overflow regrow) drops the stale result
        and a re-dispatch picks up the corrected buffers."""
        if self._bufs is not None and self._final is None:
            *_, finalize = _jits()
            self._final = finalize(*self._bufs)

    def _fetch_plan(self, final, n_reads: int):
        """Exact-granularity slices of the finalize outputs for the one
        tree fetch (scalars + per-occurrence flats + read starts + head
        tables)."""
        (gid_flat_d, m32_d, rs_sid_d, rs_pos_d, hh_d, hs_d,
         _h1, _l1, _s1, scalars_d, _pk, _pc) = final
        gran = max(4096, self.cap // 8)
        m = min(self.cap, -(-self.n_occ // gran) * gran)
        mr = min(self.cap, -(-min(n_reads, self.n_occ) // 4096) * 4096)
        # head tables (n_scm rows) ride the SECOND fetch, exact-sized
        # once the scalars land -- n_scm is typically ~n_occ/coverage,
        # so slicing them at occurrence granularity here would fetch
        # ~10-30x the needed bytes
        tree = (scalars_d, gid_flat_d[:m], m32_d[:m],
                rs_sid_d[:mr], rs_pos_d[:mr])
        return m, mr, tree

    def prefetch(self, n_reads: int):
        """Start the finalize outputs' device->host copies NOW: the
        transfer rides the wire while the loader assembles reads and the
        pipeline stats run, so build()'s device_get lands on
        already-transferred host buffers."""
        if self._final is None or self.n_occ == 0 or n_reads == 0:
            return
        m, mr, tree = self._fetch_plan(self._final, n_reads)
        for a in tree:
            try:
                a.copy_to_host_async()
            except Exception:
                break  # backend without async host copies: plain get later
        self._prefetch = (n_reads, m, mr, tree)

    def build(self, read_db):
        """Finalize on device, fetch ONE tree (ids + m_pos + smer
        payloads + read starts + head tables + scalars), restore the
        per-read views, and build the SyncmerDB on host.

        Returns None when no occurrences were collected."""
        import jax

        from .syncmer_db import build_db_from_sorted

        if self._bufs is None and self._final is None:
            return None
        self.start_finalize()
        (gid_flat_d, m32_d, rs_sid_d, rs_pos_d, hh_d, hs_d,
         h1_d, l1_d, s1_d, scalars_d, pk_u_d, pcnt_d) = self._final
        self._final = None
        self._bufs = None

        # n_occ is host-tracked (sum of per-chunk n_sel scalars), so the
        # per-occurrence flats, head tables AND the scalars come back in
        # ONE tree fetch (already in flight when the loader prefetched);
        # n_scm <= n_tot bounds the head slices
        n_exp = self.n_occ
        n_reads = len(read_db.reads)
        if n_exp == 0 or n_reads == 0:
            return None
        import os as _os
        import sys as _sys
        import time as _time

        _timeit = bool(_os.environ.get("OATK_TPU_TIMEIT"))
        _tm: dict[str, float] = {}
        _tk = [_time.perf_counter()]

        def _t(k):
            now = _time.perf_counter()
            _tm[k] = _tm.get(k, 0.0) + (now - _tk[0])
            _tk[0] = now

        pf = self._prefetch
        self._prefetch = None
        if pf is not None and pf[0] == n_reads:
            _, m, mr, tree = pf
        else:
            m, mr, tree = self._fetch_plan(
                (gid_flat_d, m32_d, rs_sid_d, rs_pos_d, hh_d, hs_d,
                 h1_d, l1_d, s1_d, scalars_d, pk_u_d, pcnt_d), n_reads
            )
        scalars, gid_flat, m32_f, rs_sid, rs_pos = jax.device_get(tree)
        _t("fetch1")
        n_tot, n_scm, n_susp, n_pu, n_ru = (int(x) for x in np.asarray(scalars))
        if n_tot != n_exp:
            raise RuntimeError(
                f"device counting holds {n_tot} occurrences, loader saw {n_exp}"
            )

        # per-read occurrence counts from the compacted read starts
        assert n_ru <= mr
        rs_sid_v = np.asarray(rs_sid[:n_ru]).astype(np.int64)
        rs_pos_v = np.asarray(rs_pos[:n_ru]).astype(np.int64)
        mc = np.zeros(n_reads, np.int64)
        mc[rs_sid_v] = np.diff(np.append(rs_pos_v, n_tot))
        offs = np.zeros(n_reads + 1, np.int64)
        np.cumsum(mc, out=offs[1:])

        m32_np = np.asarray(m32_f[:n_tot])
        if n_susp:
            # hash collision between distinct sequences: rebuild the
            # per-occurrence smer stream from the hash-sorted keys
            # (scatter by flat position), restore the per-read views,
            # then resolve exactly on host over the fetched sorted keys
            # (reference process_kmer_cluster semantics, never hit in
            # practice)
            sh, sl, ss = jax.device_get((h1_d[:m], l1_d[:m], s1_d[:m]))
            sh = np.asarray(sh[:n_tot])
            sl = np.asarray(sl[:n_tot])
            ss = np.asarray(ss[:n_tot])
            sid_s = (sl >> np.uint64(32)).astype(np.int64)
            idx_s = ((sl >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
            sm_np = np.empty(n_tot, np.uint64)
            sm_np[offs[sid_s] + idx_s] = ss
            _restore_read_views(read_db, mc, offs, m32_np, sm_np, None)
            return build_db_from_sorted(read_db, sh, sl, ss, offs)

        # second fetch, exact-sized now that the scalars are known:
        # head tables (n_scm rows) + the unique arc-pair rows that
        # make_syncmer_graph consumes instead of re-materializing and
        # radix-sorting every adjacent pair on host
        mh = min(self.cap, -(-max(n_scm, 1) // 4096) * 4096)
        mp = min(self.cap, -(-n_pu // 4096) * 4096) if n_pu > 0 else 0
        if mp:
            hh, hs, pk_u, pcnt = jax.device_get(
                (hh_d[:mh], hs_d[:mh], pk_u_d[:mp], pcnt_d[:mp])
            )
        else:
            hh, hs = jax.device_get((hh_d[:mh], hs_d[:mh]))
        _t("fetch2")

        gid_np = np.asarray(gid_flat[:n_tot])
        heads_s = np.asarray(hs[:n_scm])
        # per-occurrence smer = head smer of its cluster: guaranteed by
        # n_susp == 0 (the finalize counted every s1 != s_head lane)
        sm_np = heads_s[gid_np]
        db = _build_db_from_gid(
            read_db,
            gid_np,
            n_scm,
            np.asarray(hh[:n_scm]), heads_s,
            mc, offs, m32_np, sm_np,
        )
        _t("host_build")
        if mp:
            read_db._dev_pairs = (
                read_db.version,
                np.asarray(pk_u[:n_pu]),
                np.asarray(pcnt[:n_pu]).astype(np.int64),
            )
        if _timeit and _tm:
            parts = " ".join(f"{k}={v * 1000:.1f}ms" for k, v in _tm.items())
            print(f"[T::devcount_build] {parts}", file=_sys.stderr, flush=True)
        return db


def _restore_read_views(read_db, mc, offs, m32_np, sm_np, new_kmer):
    """Point every read's m_pos/s_mer (and k_mer when given) at its
    slice of the fetched flat arrays.  The loader appends reads in sid
    order, so slice i belongs to read i."""
    reads = read_db.reads
    if reads and (reads[0].sid != 0 or reads[-1].sid != len(reads) - 1):
        # hard check (not an assert: -O must not strip it) -- if the
        # loader ever produced out-of-order sids the slices below would
        # silently attach to the wrong reads and corrupt the assembly
        raise RuntimeError(
            f"devcount: reads not sid-contiguous (first={reads[0].sid}, "
            f"last={reads[-1].sid}, n={len(reads)})"
        )
    for i, r in enumerate(reads):
        o0, o1 = offs[i], offs[i + 1]
        r.m_pos = m32_np[o0:o1]
        r.s_mer = sm_np[o0:o1]
        if new_kmer is not None:
            r.k_mer = new_kmer[o0:o1]


def _build_db_from_gid(
    read_db, gid_flat, n_scm, heads_h, heads_s, mc, offs, m32_np, sm_np
):
    """Assemble the SyncmerDB from device-assigned ids in per-read flat
    order: coverage by bincount, position lists by a radix counting sort
    of the host-computed low keys by id -- stable over the ascending
    flat (sid, idx, rev) order, exactly the reference's per-cluster
    order -- the per-read k_mer rewrite to id<<1, and the m_pos/s_mer
    view restore (full-fetch mode: the loader never saw them)."""
    from .. import native
    from ..asm.consensus import set_read_flats
    from .syncmer_db import FlatViews, SyncmerDB

    n_tot = len(gid_flat)
    cov = np.bincount(gid_flat, minlength=n_scm).astype(np.uint32)
    cuts = np.zeros(n_scm + 1, np.int64)
    np.cumsum(cov.astype(np.int64), out=cuts[1:])

    # lows in flat order (= the reference's 128-bit key low half)
    n_reads = len(mc)
    idx = (np.arange(n_tot, dtype=np.int64) - np.repeat(offs[:-1], mc)).astype(
        np.uint64
    )
    sids = np.arange(n_reads, dtype=np.uint64)
    lows_flat = (
        (np.repeat(sids, mc) << np.uint64(32))
        | (idx << np.uint64(1))
        | (m32_np.astype(np.uint64) & np.uint64(1))
    )
    order = native.argsort_u64(gid_flat.astype(np.uint64))
    if order is None:
        order = np.argsort(gid_flat, kind="stable")
    mp_flat = lows_flat[order]

    db = SyncmerDB(
        h=heads_h.copy(),
        s=heads_s.copy(),
        cov=cov,
        del_=np.zeros(n_scm, dtype=bool),
        m_pos=FlatViews(mp_flat, cuts),
        mp_flat=mp_flat,
        mp_off=cuts,
    )

    new_kmer = gid_flat.astype(np.uint64) << np.uint64(1)
    _restore_read_views(read_db, mc, offs, m32_np, sm_np, new_kmer)
    read_db.version = getattr(read_db, "version", 0) + 1
    set_read_flats(
        read_db, mc, new_kmer, m32_np, sm_np, sids.astype(np.int64)
    )

    assert int(db.cov.sum()) == n_tot
    return db
