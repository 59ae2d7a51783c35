"""Production multi-chip syncmer collection: data-parallel extraction +
hash-range-sharded occurrence store feeding the real assembly pipeline.

This is the distributed replacement for the reference's global qsort of
128-bit (kmerhash<<64 | sid<<32 | idx<<1 | rev) keys
(/root/reference/syncmer.c:1397-1451):

- reads are sharded over the mesh axis; each device extracts closed
  syncmers from its read shard (the same selection as the single-device
  path, so hashes/positions are bit-identical);
- every occurrence is routed to its *owner* device with an all_to_all,
  ownership = top bits of the k-mer hash, so devices own ascending
  disjoint hash ranges;
- owner devices append received (hash, low) pairs into a device-resident
  buffer across batches (the streaming analogue of the reference
  accumulating `s_mer_pos_v`);
- finalize does ONE per-device 2-key sort (lax.sort on (hash, low)):
  because ownership ranges are monotone in hash, concatenating the
  per-device sorted runs in device order reproduces the reference's total
  128-bit sort order exactly -- global syncmer ids then follow from an
  exclusive scan of per-chip cluster counts, which is precisely what
  :func:`oatk_tpu.index.syncmer_db.build_db_from_sorted` computes over
  the concatenated runs.

Exact-sequence hash-collision resolution happens on the host inside
``build_db_from_sorted`` (it needs the packed read bytes); the sharded
and single-device paths share that code, so the resulting SyncmerDB --
ids, coverage, position lists, per-read k_mer rewrite -- is
byte-identical by construction, which the tests assert end-to-end via
GFA byte parity.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import numpy as np

from ..index.syncmer_db import SyncmerDB, build_db_from_sorted, flatten_occurrences

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _owner_bits(n_shards: int) -> int:
    return max(1, (n_shards - 1).bit_length())


def _dget(x) -> np.ndarray:
    """Fetch a (possibly multi-host sharded) device array to every host.

    Single-process: plain device_get.  Multi-process (jax.distributed):
    shards owned by remote hosts are not addressable, so gather them
    over DCN first -- every process then assembles the same host-side
    state, keeping the pipeline SPMD outside device code."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(jax.device_get(x))


@partial(
    jax.jit,
    static_argnames=("w", "s", "max_out", "bucket_cap", "mesh"),
    donate_argnums=(2, 3, 4, 5),
)
def _sharded_extract_route_step(
    codes,  # [D, b, L] uint8 hoco codes 0-3, 4 ambiguous, 5 padding
    sids,  # [D, b] int64 global read ids
    hbuf,  # [D, cap] uint64 carry: owned hashes (U64_MAX = empty)
    lbuf,  # [D, cap] uint64 carry: owned lows
    nbuf,  # [D] int32 carry: fill level
    ndrop,  # [D] int32 carry: dropped (capacity overflow) count
    w: int,
    s: int,
    max_out: int,
    bucket_cap: int,
    mesh,
):
    """One sharded extract + route + append step (jit; the collectives
    run between the mesh devices).

    Returns (packed[D,3,max_out+1], hbuf, lbuf, nbuf, ndrop): packed is
    the per-shard single-transfer extraction result for host-side
    ReadDB assembly; the carries accumulate owner-routed occurrences.
    """
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from ..kernels.syncmer import extract_hoco_batch

    D = mesh.devices.size
    ax = mesh.axis_names[0]
    bits = _owner_bits(D)
    cap = hbuf.shape[1]

    def step(codes_l, sids_l, hb, lb, nb, dr):
        codes_l, sids_l = codes_l[0], sids_l[0]
        hb, lb = hb[0], lb[0]
        n0, dropped = nb[0], dr[0]

        # per-device selection over host-precompressed hoco codes
        out = extract_hoco_batch(codes_l, w, s, max_out)
        khash = out["sel_khash"].astype(jnp.uint64)
        valid = out["valid"]
        sel_b = out["sel_b"]  # sorted ascending; == B for invalid lanes
        sel_z = out["sel_z"].astype(jnp.uint64)

        # global (sid, idx, rev) per occurrence; idx = rank within read
        # (flat order is (read, position) ascending == emission order)
        first = jnp.searchsorted(sel_b, sel_b)
        idx = (jnp.arange(max_out, dtype=jnp.int64) - first).astype(jnp.uint64)
        sid = sids_l[jnp.where(valid, sel_b, 0)].astype(jnp.uint64)
        low = (sid << jnp.uint64(32)) | (idx << jnp.uint64(1)) | sel_z
        low = jnp.where(valid, low, U64_MAX)
        khash = jnp.where(valid, khash, U64_MAX)

        # owner = top hash bits -> ascending disjoint hash ranges
        owner = (khash >> jnp.uint64(64 - bits)).astype(jnp.int32)
        owner = jnp.minimum(owner, D - 1)
        owner = jnp.where(valid, owner, D)  # invalid -> dropped lane

        # fixed-capacity routing buckets [D, bucket_cap]
        order = jnp.argsort(owner, stable=True)
        so, sh_, slw = owner[order], khash[order], low[order]
        start = jnp.searchsorted(so, jnp.arange(D, dtype=jnp.int32))
        end = jnp.searchsorted(so, jnp.arange(1, D + 1, dtype=jnp.int32))
        cnt = end - start
        dropped = dropped + jnp.sum(jnp.maximum(cnt - bucket_cap, 0))
        pos = start[:, None] + jnp.arange(bucket_cap)[None, :]
        in_r = jnp.arange(bucket_cap)[None, :] < jnp.minimum(cnt, bucket_cap)[:, None]
        safe = jnp.clip(pos, 0, max_out - 1)
        bkt_h = jnp.where(in_r, sh_[safe], U64_MAX)
        bkt_l = jnp.where(in_r, slw[safe], U64_MAX)

        # exchange: bucket d of every shard lands on shard d
        recv_h = lax.all_to_all(bkt_h[None], ax, split_axis=1, concat_axis=0).reshape(-1)
        recv_l = lax.all_to_all(bkt_l[None], ax, split_axis=1, concat_axis=0).reshape(-1)

        # compact valid-first (preserve order) and append at fill level
        rvalid = recv_l != U64_MAX
        n_recv = jnp.sum(rvalid, dtype=jnp.int32)
        corder = jnp.argsort(~rvalid, stable=True)
        ch, cl = recv_h[corder], recv_l[corder]
        # append; buffers carry D*bucket_cap slack so a clamped write
        # start of (cap_data) stays in bounds
        wr = jnp.minimum(n0, cap - ch.shape[0]).astype(jnp.int32)
        hb = lax.dynamic_update_slice(hb, ch, (wr,))
        lb = lax.dynamic_update_slice(lb, cl, (wr,))
        n1 = n0 + n_recv
        dropped = dropped + jnp.maximum(n1 - (cap - ch.shape[0]), 0) - jnp.maximum(
            n0 - (cap - ch.shape[0]), 0
        )
        return (
            out["packed"][None],
            hb[None],
            lb[None],
            n1[None],
            dropped[None],
        )

    shard_map = jax.shard_map
    return shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P(ax, None, None),
            P(ax, None),
            P(ax, None),
            P(ax, None),
            P(ax),
            P(ax),
        ),
        out_specs=(P(ax, None, None), P(ax, None), P(ax, None), P(ax), P(ax)),
        check_vma=False,
    )(codes, sids, hbuf, lbuf, nbuf, ndrop)


@partial(jax.jit, static_argnames=("mesh",), donate_argnums=(0, 1))
def _sharded_finalize_sort(hbuf, lbuf, mesh):
    """Per-shard 2-key sort of the accumulated (hash, low) pairs.

    Invalid slots are (U64_MAX, U64_MAX) and sort to the end of each
    shard's run."""
    from jax import lax
    from jax.sharding import PartitionSpec as P

    ax = mesh.axis_names[0]

    def srt(hb, lb):
        h, l = lax.sort((hb[0], lb[0]), num_keys=2)
        return h[None], l[None]

    return jax.shard_map(
        srt,
        mesh=mesh,
        in_specs=(P(ax, None), P(ax, None)),
        out_specs=(P(ax, None), P(ax, None)),
        check_vma=False,
    )(hbuf, lbuf)


@dataclass
class ShardedSyncmerCollector:
    """Accumulates hash-routed syncmer occurrences on a device mesh and
    builds the SyncmerDB at finalize."""

    mesh: object
    w: int
    s: int
    shard_cap: int  # per-shard data capacity (occurrences owned)
    bucket_cap: int  # per-(shard, dest) routing capacity per step
    _state: tuple | None = field(default=None, repr=False)
    n_steps: int = 0

    def _init_state(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        D = self.mesh.devices.size
        ax = self.mesh.axis_names[0]
        cap = self.shard_cap + D * self.bucket_cap  # slack for clamped writes
        sh2 = NamedSharding(self.mesh, P(ax, None))
        sh1 = NamedSharding(self.mesh, P(ax))
        hbuf = jax.device_put(jnp.full((D, cap), U64_MAX, jnp.uint64), sh2)
        lbuf = jax.device_put(jnp.full((D, cap), U64_MAX, jnp.uint64), sh2)
        nbuf = jax.device_put(jnp.zeros(D, jnp.int32), sh1)
        ndrop = jax.device_put(jnp.zeros(D, jnp.int32), sh1)
        self._state = (hbuf, lbuf, nbuf, ndrop)

    def add_batch(self, codes: np.ndarray, sids: np.ndarray, max_out: int):
        """Extract + route one read batch.  codes [B, L] hoco codes with
        B divisible by the mesh size (pad with all-padding rows).  Returns
        the per-shard packed extraction results [D, 3, max_out+1] (host
        np array)."""
        if self._state is None:
            self._init_state()
        D = self.mesh.devices.size
        B = codes.shape[0]
        assert B % D == 0, "batch rows must be divisible by the mesh size"
        b = B // D
        packed, hbuf, lbuf, nbuf, ndrop = _sharded_extract_route_step(
            codes.reshape(D, b, -1),
            sids.reshape(D, b),
            *self._state,
            w=self.w,
            s=self.s,
            max_out=max_out,
            bucket_cap=self.bucket_cap,
            mesh=self.mesh,
        )
        self._state = (hbuf, lbuf, nbuf, ndrop)
        self.n_steps += 1
        return _dget(packed)

    def _build_multiproc(self, read_db, hs_dev, ls_dev, n_per_shard):
        return _build_multiproc_impl(read_db, hs_dev, ls_dev, n_per_shard)

    def build(self, read_db) -> SyncmerDB | None:
        """Finalize: per-shard sort, gather runs in shard order (= global
        128-bit key order), and build the DB with the shared host code.

        Cross-checks the carry against the assembled ReadDB: per-shard
        valid counts must sum to the total occurrence count and no
        routing/append drops may have occurred."""
        if self._state is None or read_db.total_syncmers() == 0:
            return None
        hbuf, lbuf, nbuf, ndrop = self._state
        n_per_shard = _dget(nbuf)
        drops = int(_dget(ndrop).sum())
        if drops:
            raise RuntimeError(
                f"sharded syncmer routing dropped {drops} occurrences; "
                f"raise shard_cap/bucket_cap"
            )
        hs, ls = _sharded_finalize_sort(hbuf, lbuf, mesh=self.mesh)
        self._state = None
        if jax.process_count() > 1:
            try:
                return self._build_multiproc(read_db, hs, ls, n_per_shard)
            except Exception as e:  # pragma: no cover - defensive
                import sys

                print(
                    f"[W::sharded_db] sharded host build failed ({e}); "
                    "falling back to replicated build",
                    file=sys.stderr,
                )
        hs = _dget(hs)
        ls = _dget(ls)

        # concatenate per-shard sorted runs in shard order; global ids =
        # exclusive scan of shard counts + local cluster index, realized
        # by building over the concatenation
        sh = np.concatenate([hs[d, : n_per_shard[d]] for d in range(len(n_per_shard))])
        sl = np.concatenate([ls[d, : n_per_shard[d]] for d in range(len(n_per_shard))])

        n_tot = read_db.total_syncmers()
        if len(sh) != n_tot:
            raise RuntimeError(
                f"sharded collector holds {len(sh)} occurrences, ReadDB has {n_tot}"
            )
        # smer payloads + per-read bases from the assembled ReadDB (the
        # sequence bytes live host-side for collision resolution anyway)
        _, _, smers, base = flatten_occurrences(read_db)
        sid = (sl >> np.uint64(32)).astype(np.int64)
        idx = ((sl >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
        ss = smers[base[sid] + idx]
        return build_db_from_sorted(read_db, sh, sl, ss, base)


def _build_multiproc_impl(read_db, hs_dev, ls_dev, n_per_shard):
    """Process-sharded host DB assembly.

    The replicated build allgathers every shard's raw sorted keys
    (16 B/occurrence over DCN) and then EVERY process clusters the full
    concatenation.  Here each process clusters only the hash-range
    shards whose device rows it owns (clusters cannot span shards:
    ownership is by hash prefix), and the allgather ships RESULTS --
    per-cluster heads/coverage (~1/coverage the rows) plus the
    8 B/occurrence grouped lows that become mp_flat -- so both the
    wire bytes and the dominant clustering/sort compute drop by the
    process count.  Shard results are re-ordered by global shard id
    after the gather, which restores the exact global 128-bit key
    order; the assembled SyncmerDB is byte-identical to the replicated
    build (asserted by tests/test_multiprocess_dist.py against the
    single-process host build)."""
    from ..index.syncmer_db import (
        assemble_db_from_clusters,
        cluster_occurrences,
        flatten_occurrences,
    )
    from .stages import _allgather_var

    _, _, smers, base = flatten_occurrences(read_db)

    # local shards with their global shard index
    local = []
    lshards = {s.index[0].start or 0: s for s in ls_dev.addressable_shards}
    for sh_ in hs_dev.addressable_shards:
        g0 = sh_.index[0].start or 0
        hdata = np.asarray(sh_.data)
        ldata = np.asarray(lshards[g0].data)
        for r in range(hdata.shape[0]):
            local.append((g0 + r, hdata[r], ldata[r]))
    local.sort(key=lambda t: t[0])

    ids, meta, hparts, sparts, covparts, clparts = [], [], [], [], [], []
    for g, hrow, lrow in local:
        n = int(n_per_shard[g])
        hrun, lrun = hrow[:n], lrow[:n]
        sid = (lrun >> np.uint64(32)).astype(np.int64)
        idx = ((lrun >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
        ssr = smers[base[sid] + idx] if n else np.zeros(0, np.uint64)
        gid, n_scm_l, rep = cluster_occurrences(read_db, hrun, lrun, ssr)
        cov_l = np.bincount(gid, minlength=n_scm_l).astype(np.int64)
        if n_scm_l and not bool((gid[1:] >= gid[:-1]).all()):
            cl = lrun[np.argsort(gid, kind="stable")]
        else:
            cl = lrun
        ids.append(g)
        meta.append((n_scm_l, n))
        hparts.append(hrun[rep])
        sparts.append(ssr[rep])
        covparts.append(cov_l)
        clparts.append(cl)

    z64 = np.zeros(0, np.uint64)
    zi = np.zeros(0, np.int64)
    tag = np.asarray(
        [[g, m[0], m[1]] for g, m in zip(ids, meta)], np.int64
    ).reshape(-1, 3)
    tag_all = _allgather_var(tag)
    h_all = _allgather_var(np.concatenate(hparts) if hparts else z64)
    s_all = _allgather_var(np.concatenate(sparts) if sparts else z64)
    c_all = _allgather_var(np.concatenate(covparts) if covparts else zi)
    cl_all = _allgather_var(np.concatenate(clparts) if clparts else z64)

    # reorder per-shard slices by global shard id
    recs = []
    for r in range(len(tag_all)):
        t = tag_all[r].reshape(-1, 3)
        o_scm = o_occ = 0
        for g, n_scm_l, n_occ_l in t:
            recs.append((
                int(g),
                h_all[r][o_scm : o_scm + n_scm_l],
                s_all[r][o_scm : o_scm + n_scm_l],
                c_all[r][o_scm : o_scm + n_scm_l],
                cl_all[r][o_occ : o_occ + n_occ_l],
            ))
            o_scm += int(n_scm_l)
            o_occ += int(n_occ_l)
    recs.sort(key=lambda t: t[0])
    gids_seen = [t[0] for t in recs]
    if gids_seen != sorted(set(gids_seen)) or len(gids_seen) != len(n_per_shard):
        raise RuntimeError(f"shard results incomplete: {gids_seen}")
    h_heads = np.concatenate([t[1] for t in recs])
    s_heads = np.concatenate([t[2] for t in recs])
    cov = np.concatenate([t[3] for t in recs])
    cl_sorted = np.concatenate([t[4] for t in recs])
    n_tot = read_db.total_syncmers()
    if len(cl_sorted) != n_tot:
        raise RuntimeError(
            f"sharded collector holds {len(cl_sorted)} occurrences, "
            f"ReadDB has {n_tot}"
        )
    return assemble_db_from_clusters(
        read_db, h_heads, s_heads, cov.astype(np.uint32), cl_sorted, base
    )


def load_and_extract_sharded(
    paths: list[str],
    w: int,
    s: int,
    mesh,
    max_data: int = 0,
    batch_bases: int = 8 << 20,
):
    """Multi-device analogue of :func:`oatk_tpu.asm.reads.load_and_extract`:
    reads stream through the mesh in length-bucketed batches of 1-byte
    hoco codes, extraction runs data-parallel per shard, occurrences are
    hash-routed to owner shards, and the host assembles the per-read
    view from the per-shard extraction results.

    Returns (ReadDB, ShardedSyncmerCollector); call ``collector.build``
    after read stats to obtain the SyncmerDB (matching the reference's
    stage order: sr_db_stat runs on raw hashes before
    collect_syncmer_from_reads rewrites them, run_syncasm.c:88-103).
    """
    from .. import native as _native
    from ..asm.reads import ReadDB, _round_up, _unpack_packed
    from ..io.fastx import read_fastx, read_source_bytes
    from ..kernels.oracle import ReadSyncmers, hoco_compress_np

    D = mesh.devices.size
    res = None
    if _native.available() and max_data == 0:
        # threaded native FASTA/hoco parse (the python reader dominated
        # large sharded runs)
        names_l, hoco = [], []
        total_bases = 0
        flat_parts = []  # (codes, rl, offs, ovf_pos, ovf_len) per file
        from ..asm.reads import _read_isn_views

        for path in paths:
            res = _native.parse_fastx_hoco_mt(read_source_bytes(path))
            if res is None:
                break
            names, rawlen, offs, codes, rlv, isn_pos, ovf_p, ovf_l = res
            isn_views = _read_isn_views(isn_pos, offs, len(names))
            for i in range(len(names)):
                o0, o1 = int(offs[i]), int(offs[i + 1])
                hoco.append((codes[o0:o1], rlv[o0:o1], isn_views[i]))
            names_l.extend(names)
            total_bases += int(rawlen.sum())
            flat_parts.append((codes, rlv, offs, ovf_p, ovf_l))
    if res is None:
        flat_parts = None
        records = read_fastx(paths, max_data)
        names_l = [r.name for r in records]
        hoco = [hoco_compress_np(r.seq) for r in records]
        total_bases = sum(len(r.seq) for r in records)
    n_records = len(hoco)
    db = ReadDB(k=w, s=s)
    db.reads = [None] * n_records  # type: ignore
    if flat_parts:
        # whole-run hoco streams (per-read arrays are views into them):
        # consumers (_Flats) reuse these instead of re-concatenating
        base = 0
        offs_all = []
        ovf_pos_all = []
        ovf_len_all = []
        for codes, rlv, offs, ovf_p, ovf_l in flat_parts:
            offs_all.append(offs[:-1].astype(np.int64) + base)
            if len(ovf_p):
                ovf_pos_all.append(ovf_p + base)
                ovf_len_all.append(ovf_l)
            base += int(offs[-1])
        db.hoco_flat = (
            flat_parts[0][0] if len(flat_parts) == 1
            else np.concatenate([p[0] for p in flat_parts])
        )
        db.rl_flat = (
            flat_parts[0][1] if len(flat_parts) == 1
            else np.concatenate([p[1] for p in flat_parts])
        )
        z64 = np.zeros(0, np.int64)
        db.rl_ovf_pos = np.concatenate(ovf_pos_all) if ovf_pos_all else z64
        db.rl_ovf_len = np.concatenate(ovf_len_all) if ovf_len_all else z64
        db.hoco_off = np.concatenate(
            offs_all + [np.asarray([base], np.int64)]
        ).astype(np.int64, copy=False)

    # rough global occurrence bound for the carry capacity: ~1 syncmer
    # per (w-s)/3 hoco bases, doubled for skew across hash ranges;
    # OATK_TPU_SHARD_CAP_SCALE widens it for pathological distributions
    # (overflow otherwise falls back to the host sort, see pipeline)
    import os as _os

    scale = float(_os.environ.get("OATK_TPU_SHARD_CAP_SCALE", "1.0"))
    est = int(total_bases / max(4, (w - s) // 3)) + 1024
    shard_cap = _round_up(int(2 * scale * est) // D + 4096, 1024)

    buckets: dict[int, list[int]] = {}
    for i in range(n_records):
        L = max(len(hoco[i][0]), w + 4)
        Lp = max(512, 1 << int(np.ceil(np.log2(L))))
        buckets.setdefault(Lp, []).append(i)

    # chunk plan first: the routing bucket capacity is static per
    # collector and must cover the worst single-chunk skew (everything
    # on one shard routed to one owner)
    plan = []
    for Lp, idxs in sorted(buckets.items()):
        bsz = _round_up(max(D, batch_bases // Lp), D)
        for start in range(0, len(idxs), bsz):
            chunk = idxs[start : start + bsz]
            B = _round_up(len(chunk), D)
            max_out = _round_up(
                max(1024, int((B // D) * Lp / max(4, (w - s) // 3)) * 2), 1024
            )
            plan.append((Lp, chunk, B, max_out))

    collector = None
    if plan:
        collector = ShardedSyncmerCollector(
            mesh=mesh, w=w, s=s, shard_cap=shard_cap,
            bucket_cap=max(p[3] for p in plan),
        )
    for Lp, chunk, B, max_out in plan:
            sids = np.zeros(B, dtype=np.int64)
            # hoco codes 0-3 (+4 ambiguous, 5 pad): 1 B/hoco base and no
            # device-side recompression
            codes = np.full((B, Lp), 5, dtype=np.uint8)
            for bi, ri in enumerate(chunk):
                code, _, is_n = hoco[ri]
                row = code.astype(np.uint8, copy=True)
                if is_n.any():
                    row[is_n] = 4
                codes[bi, : len(row)] = row
                sids[bi] = ri
            packed = collector.add_batch(codes, sids, max_out)

            bpd = B // D
            for d in range(D):
                pk = packed[d]
                n_sel = int(pk[0, max_out])
                if n_sel > max_out:
                    raise RuntimeError(
                        f"sharded extraction overflow on shard {d}: "
                        f"{n_sel} > {max_out}; raise batch capacity"
                    )
                sel_b, sel_p, sel_z, sel_smer, sel_kh = _unpack_packed(pk, n_sel, Lp)
                cuts = np.searchsorted(sel_b, np.arange(bpd + 1))
                for bl in range(bpd):
                    gi = d * bpd + bl
                    if gi >= len(chunk):
                        continue
                    ri = chunk[gi]
                    lo, hi = cuts[bl], cuts[bl + 1]
                    code, ho_rl, is_n = hoco[ri]
                    db.reads[ri] = ReadSyncmers(
                        sid=ri,
                        name=names_l[ri],
                        hoco_l=len(code),
                        hoco_code=code,
                        ho_rl=ho_rl,
                        is_n=is_n,
                        m_pos=(
                            (sel_p[lo:hi].astype(np.uint32) << 1)
                            | sel_z[lo:hi].astype(np.uint32)
                        ),
                        s_mer=sel_smer[lo:hi].astype(np.uint64),
                        k_mer=sel_kh[lo:hi].copy(),
                    )
    if collector is None:  # no reads at all
        collector = ShardedSyncmerCollector(
            mesh=mesh, w=w, s=s, shard_cap=1024, bucket_cap=1024
        )
    return db, collector
