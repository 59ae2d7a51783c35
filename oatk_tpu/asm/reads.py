"""Read database: batched device syncmer extraction -> per-read records.

The device extractor (:func:`oatk_tpu.kernels.syncmer.extract_hoco_fused`
on the main path) runs over length-bucketed padded batches; this module
assembles the results into the per-read view (sr_db analogue,
/root/reference/syncmer.h:48-84) consumed by graph construction,
alignment, consensus and error correction.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fastx import SeqRecord
from ..kernels.oracle import ReadSyncmers, hoco_compress_np, syncmers_of_read_oracle
from ..utils import log_info


@dataclass
class ReadDB:
    """All reads with hoco sequences and per-read syncmer lists."""

    k: int  # k-mer size (hoco bases); reference's 'w'
    s: int  # s-mer size
    reads: list[ReadSyncmers] = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    version: int = 0  # bumped whenever read arrays mutate (EC)
    # whole-run hoco streams in sid order (set by the native loader;
    # per-read hoco_code/ho_rl are views into these).  Consumers
    # (consensus _Flats) reuse them instead of re-concatenating ~100 MB
    # of per-read arrays.  Immutable: EC splices only syncmer arrays.
    hoco_flat: np.ndarray | None = None  # uint8 codes
    rl_flat: np.ndarray | None = None  # uint8 run length - 1, saturated 255
    hoco_off: np.ndarray | None = None  # int64 [n+1] read offsets
    # exact run-length-1 values for saturated rl_flat entries, sorted by
    # global stream position (the reference's ho_l_rl overflow list)
    rl_ovf_pos: np.ndarray | None = None  # int64 global hoco positions
    rl_ovf_len: np.ndarray | None = None  # int64 exact run-length-1

    @property
    def n(self) -> int:
        return len(self.reads)

    def total_syncmers(self) -> int:
        return sum(len(r.m_pos) for r in self.reads)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _timeit_enabled() -> bool:
    import os

    return bool(os.environ.get("OATK_TPU_TIMEIT"))


# bytes per pipeline segment of the fused loader (tests shrink this to
# force multi-segment splits on small inputs)
_SEG_BYTES = 4 << 20
# padded bases per device chunk of the fused loader
_BATCH_BASES = 32 << 20


def _sel_divisor(w: int, s: int) -> int:
    """Positions-per-selected-syncmer estimate for the device capacity.

    Expected closed-syncmer density is ~2/(w-s+2); at production k
    (w>=500) observed density is ~half that, so a (w-s)/2 divisor still
    leaves ~2x headroom while shrinking the fetched result ~35%.  Small
    k keeps the conservative (w-s)/3 (density varies more and an
    overflow retry costs a fresh XLA compile)."""
    return max(4, (w - s) // 2 if w >= 500 else (w - s) // 3)


def expected_key_lanes(nbytes: int, w: int, s: int) -> int:
    """Device-count key lanes the loader appends for ``nbytes`` of
    input: ~padded-hoco/sel_divisor (measured ~0.8 x raw bytes /
    divisor) plus one 1024-lane rounding per segment."""
    return int(0.8 * nbytes / _sel_divisor(w, s)) + (nbytes // _SEG_BYTES + 2) * 1024


def _bucket_len(L: int) -> int:
    """Padded row length for a read: powers of two up to 4096, then
    multiples of 2048.  The padded grid is what is uploaded AND what the
    device kernel scans, so padding waste costs twice; 2048-steps hold
    typical HiFi hoco spreads to <10% waste while keeping the
    compiled-shape count small."""
    if L <= 512:
        return 512
    if L <= 4096:
        return 1 << int(np.ceil(np.log2(L)))
    return _round_up(L, 2048)


def _pad_rows(n: int, bsz: int) -> int:
    """Pad a chunk's row count to a multiple of 64 (capped at the full
    chunk size).  Coarse enough that same-sized parse segments reuse a
    cached XLA program, fine enough that row padding stays <~10% (the
    padded rows are uploaded and scanned like real ones)."""
    return min(max(64, _round_up(n, 64)), bsz)


_false_buf = np.zeros(1 << 14, bool)


def _new_blob(B: int, Lp: int, n_cap: int, n_pos) -> tuple:
    """One chunk's upload blob in the :func:`extract_hoco_fused` layout:
    2-bit packed rows | per-row hoco lengths (i32) | flat N positions
    (i32, padded with the B*Lp sentinel).  Returns (blob, packed rows
    view, lengths view) for the caller to fill."""
    pk_b = B * (Lp // 4)
    blob = np.zeros(pk_b + 4 * B + 4 * n_cap, np.uint8)
    n_arr = blob[pk_b + 4 * B :].view(np.int32)
    n_arr[:] = B * Lp
    n_arr[: len(n_pos)] = n_pos
    packed = blob[:pk_b].reshape(B, Lp // 4)
    return blob, packed, blob[pk_b : pk_b + 4 * B].view(np.int32)


def _false_view(n: int) -> np.ndarray:
    """Read-only all-False view for N-free reads (Ns are rare; one
    shared buffer replaces a per-read dense flag array)."""
    global _false_buf
    if n > len(_false_buf):
        _false_buf = np.zeros(max(n, 2 * len(_false_buf)), bool)
    return _false_buf[:n]


def _read_isn_views(isn_pos: np.ndarray, offs: np.ndarray, n_reads: int):
    """Per-read is_n bool arrays from the sparse ambiguous-position
    list (positions in the same coordinates as ``offs``)."""
    lo = np.searchsorted(isn_pos, offs[:n_reads])
    hi = np.searchsorted(isn_pos, offs[1 : n_reads + 1])
    out = [None] * n_reads
    for ri in range(n_reads):
        l0 = int(offs[ri + 1]) - int(offs[ri])
        if hi[ri] > lo[ri]:
            d = np.zeros(l0, bool)
            d[isn_pos[lo[ri] : hi[ri]] - int(offs[ri])] = True
            out[ri] = d
        else:
            out[ri] = _false_view(l0)
    return out


def _unpack_packed(pk: np.ndarray, n_sel: int, Lp: int):
    """Decode the kernel's single-transfer [3, max_out+1] int64 result:
    row0 = flat_idx<<1|z (slot max_out = n_sel), row1 = smer payload,
    row2 = bitcast Murmur hash.  (Only the host-sort counting path
    fetches packed rows; device-resident counting fetches nothing per
    chunk beyond the n_sel scalar -- see DevCountState.build.)"""
    flat = pk[0, :n_sel]
    sel_z = (flat & 1).astype(np.int32)
    fi = flat >> 1
    sel_b = (fi // Lp).astype(np.int32)
    sel_p = (fi % Lp).astype(np.int32)
    sel_smer = pk[1, :n_sel].astype(np.uint64)
    sel_kh = pk[2, :n_sel].view(np.uint64) if pk.shape[0] > 2 else None
    return sel_b, sel_p, sel_z, sel_smer, sel_kh


def _device_hoco_enabled() -> bool:
    import os

    return os.environ.get("OATK_TPU_DEVICE_HOCO", "0") not in ("", "0")


def extract_all_syncmers(
    records: list[SeqRecord],
    w: int,
    s: int,
    use_device: bool = True,
    batch_bases: int = _BATCH_BASES,
) -> ReadDB:
    """Run syncmer extraction for all reads.

    Reads are bucketed by padded hoco length (powers-of-two-ish) so XLA
    compiles a handful of batch shapes; each bucket streams through the
    device in chunks of ~batch_bases.  The host homopolymer-compresses
    and 2-bit packs the reads; the device runs
    :func:`oatk_tpu.kernels.syncmer.extract_hoco_fused`.
    """
    db = ReadDB(k=w, s=s)
    db.reads = [None] * len(records)  # type: ignore

    if not use_device:
        for i, rec in enumerate(records):
            db.reads[i] = syncmers_of_read_oracle(rec.seq, w, s, rec.sid, rec.name)
        return db

    if _device_hoco_enabled():
        return _extract_device_hoco(db, records, w, s, batch_bases)

    import jax
    import jax.numpy as jnp

    from ..kernels.oracle import pack_hoco
    from ..kernels.syncmer import extract_hoco_fused

    # host-side homopolymer compression (needed for consensus/EC anyway);
    # the device consumes 2-bit packed hoco codes + sparse N positions
    hoco: list[tuple] = [hoco_compress_np(rec.seq) for rec in records]

    # bucket by padded hoco length
    buckets: dict[int, list[int]] = {}
    for i in range(len(records)):
        Lp = _bucket_len(max(len(hoco[i][0]), w + 4))
        buckets.setdefault(Lp, []).append(i)

    # dispatch all chunks first (uploads/compute pipeline through the
    # device queue), then fetch + assemble
    pending: list[tuple] = []
    for Lp, idxs in sorted(buckets.items()):
        bsz = max(1, batch_bases // Lp)
        for start in range(0, len(idxs), bsz):
            chunk = idxs[start : start + bsz]
            B = _pad_rows(len(chunk), bsz)
            max_out = _round_up(max(1024, int(B * Lp / _sel_divisor(w, s))), 1024)
            n_pos = [bi * Lp + int(p) for bi, ri in enumerate(chunk)
                     for p in np.flatnonzero(hoco[ri][2])]
            n_cap = 0 if not n_pos else _round_up(max(64, len(n_pos)), 1024)
            blob, packed, hoco_l = _new_blob(B, Lp, n_cap, n_pos)
            for bi, ri in enumerate(chunk):
                code = hoco[ri][0]
                packed[bi, : (len(code) + 3) // 4] = pack_hoco(code)
                hoco_l[bi] = len(code)
            args = (jnp.asarray(blob), B, Lp, n_cap)
            out = extract_hoco_fused(*args, w, s, max_out)
            pending.append((chunk, B, Lp, max_out, args, out))

    for chunk, B, Lp, max_out, args, out in pending:
        pk = np.asarray(jax.device_get(out["packed"]))
        n_sel = int(pk[0, max_out])
        while n_sel > max_out:
            # capacity overflow (pathological density): redo this chunk
            # synchronously with a grown buffer
            max_out = _round_up(n_sel + 1024, 1024)
            out = extract_hoco_fused(*args, w, s, max_out)
            pk = np.asarray(jax.device_get(out["packed"]))
            n_sel = int(pk[0, max_out])
        sel_b, sel_p, sel_z, sel_smer, sel_kh = _unpack_packed(pk, n_sel, Lp)
        cuts = np.searchsorted(sel_b, np.arange(B + 1))
        for bi, ri in enumerate(chunk):
            lo, hi = cuts[bi], cuts[bi + 1]
            code, ho_rl, is_n = hoco[ri]
            db.reads[ri] = ReadSyncmers(
                sid=records[ri].sid,
                name=records[ri].name,
                hoco_l=len(code),
                hoco_code=code,
                ho_rl=ho_rl,
                is_n=is_n,
                m_pos=((sel_p[lo:hi].astype(np.uint32)) << 1 | sel_z[lo:hi].astype(np.uint32)),
                s_mer=sel_smer[lo:hi],
                k_mer=sel_kh[lo:hi].copy(),
            )
    return db


def _extract_device_hoco(db, records, w, s, batch_bases):
    """OATK_TPU_DEVICE_HOCO=1 path: upload RAW ASCII reads (1 B/base)
    and run homopolymer compression ON DEVICE (the hoco phase of
    :func:`oatk_tpu.kernels.syncmer.extract_syncmers_batch`), fetching
    the hoco arrays back for the host-side DB.

    Trade: the host never runs its hoco+pack pass, but the upload
    carries 4x the bytes and the download an extra ~5 B/base (hoco codes
    + run lengths).  Byte parity with the host-hoco path is asserted by
    tests/test_load_extract.py::test_device_hoco_parity.
    """
    import jax
    import jax.numpy as jnp

    from ..kernels.syncmer import extract_syncmers_batch

    # bucket by padded RAW length (hoco length is unknown host-side)
    buckets: dict[int, list[int]] = {}
    for i, rec in enumerate(records):
        Lp = _bucket_len(max(len(rec.seq), w + 4))
        buckets.setdefault(Lp, []).append(i)

    def run(chunk, B, Lp, max_out):
        seq = np.zeros((B, Lp), dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        for bi, ri in enumerate(chunk):
            sq = records[ri].seq
            seq[bi, : len(sq)] = sq
            lens[bi] = len(sq)
        return extract_syncmers_batch(
            jnp.asarray(seq), jnp.asarray(lens), w, s, max_out, return_hoco=True
        )

    pending: list[tuple] = []
    for Lp, idxs in sorted(buckets.items()):
        bsz = max(1, batch_bases // Lp)
        for start in range(0, len(idxs), bsz):
            chunk = idxs[start : start + bsz]
            B = _pad_rows(len(chunk), bsz)
            max_out = _round_up(max(1024, int(B * Lp / _sel_divisor(w, s))), 1024)
            pending.append((chunk, B, Lp, max_out, run(chunk, B, Lp, max_out)))

    for chunk, B, Lp, max_out, out in pending:
        while True:
            pk, hc, hl, rl, isn = jax.device_get(
                (out["packed"], out["hoco_c"], out["hoco_l"], out["ho_rl"], out["is_n"])
            )
            pk = np.asarray(pk)
            n_sel = int(pk[0, max_out])
            if n_sel <= max_out:
                break
            # capacity overflow (pathological density): redo this chunk
            # synchronously with a grown buffer
            max_out = _round_up(n_sel + 1024, 1024)
            out = run(chunk, B, Lp, max_out)
        sel_b, sel_p, sel_z, sel_smer, sel_kh = _unpack_packed(pk, n_sel, Lp)
        cuts = np.searchsorted(sel_b, np.arange(B + 1))
        for bi, ri in enumerate(chunk):
            lo, hi = cuts[bi], cuts[bi + 1]
            n_h = int(hl[bi])
            db.reads[ri] = ReadSyncmers(
                sid=records[ri].sid,
                name=records[ri].name,
                hoco_l=n_h,
                hoco_code=np.asarray(hc[bi, :n_h], np.uint8),
                ho_rl=np.asarray(rl[bi, :n_h]).astype(np.uint32),
                is_n=np.asarray(isn[bi, :n_h], bool),
                m_pos=(
                    (sel_p[lo:hi].astype(np.uint32)) << 1
                    | sel_z[lo:hi].astype(np.uint32)
                ),
                s_mer=sel_smer[lo:hi],
                k_mer=sel_kh[lo:hi].copy(),
            )
    return db


def _parse_pack_segment(
    data: bytes, c0: int, c1: int, w: int, s: int, batch_bases: int, out3=None,
    tacc: list | None = None,
):
    """Worker: native parse+hoco of one byte range [c0, c1), then 2-bit
    pack all its chunks into upload blobs.  Runs off the main thread
    (the C parse releases the GIL) so segment i+1 parses while segment
    i's blobs upload/compute on the device.  The range is parsed in
    place — no segment slice copy — and with ``out3`` straight into the
    caller's whole-file arrays (no per-segment allocation either).
    Returns (parse_result, [(chunk_read_idxs, B, Lp, max_out, n_cap,
    blob)]) or None.  ``tacc`` collects (parse_s, pack_s) per segment
    (worker-side CPU wall, summed across overlapped workers)."""
    import time as _time

    from .. import native

    _t0 = _time.perf_counter()
    res = native.parse_fastx_hoco(data, c0, c1, out=out3)
    _t_parse = _time.perf_counter() - _t0
    if res is None:
        return None
    names, rawlen, offs, codes, rl, isn_idx = res[:6]
    n_reads = len(names)
    hoco_l = (offs[1:] - offs[:-1]).astype(np.int64)

    buckets: dict[int, list[int]] = {}
    for i in range(n_reads):
        L = max(int(hoco_l[i]), w + 4)
        buckets.setdefault(_bucket_len(L), []).append(i)

    chunks = []
    # sparse ambiguous positions straight from the parser (parse-local
    # coordinates, same as offs)
    for Lp, idxs in sorted(buckets.items()):
        bsz = max(1, batch_bases // Lp)
        for start in range(0, len(idxs), bsz):
            chunk = idxs[start : start + bsz]
            B = _pad_rows(len(chunk), bsz)
            max_out = _round_up(max(1024, int(B * Lp / _sel_divisor(w, s))), 1024)
            st = offs[chunk]
            en = offs[np.asarray(chunk) + 1]
            n_pos = _chunk_n_positions(isn_idx, st, en, Lp)
            n_cap = 0 if not len(n_pos) else _round_up(max(64, len(n_pos)), 1024)
            # one blob = one host->device copy per chunk; the packed
            # grid / lengths are written straight into their blob slices
            blob, packed, hl = _new_blob(B, Lp, n_cap, n_pos)
            native.pack_rows_gather(codes, st, en, Lp // 4, out=packed)
            hl[: len(chunk)] = (en - st).astype(np.int32)
            chunks.append((chunk, B, Lp, max_out, n_cap, blob))
    if tacc is not None:
        tacc.append((_t_parse, _time.perf_counter() - _t0 - _t_parse))
    return res, chunks


def _segment_bounds(data: bytes, cuts) -> list[tuple[int, int]]:
    """[c0, c1) byte ranges from record cuts (None: one segment)."""
    return [(0, len(data))] if cuts is None else list(zip(cuts[:-1], cuts[1:]))


def loader_chunks(data: bytes, w: int, s: int):
    """The (B, Lp, max_out, n_cap, blob) chunks the pipelined loader
    cuts from one FASTA/FASTQ buffer, in dispatch order: the inputs of
    :func:`oatk_tpu.kernels.syncmer.extract_hoco_fused`, for compiling
    and timing its real shapes outside a run."""
    from .. import native

    cuts = native.segment_record_cuts(data, max(1, len(data) // _SEG_BYTES))
    for c0, c1 in _segment_bounds(data, cuts):
        pr = _parse_pack_segment(data, c0, c1, w, s, _BATCH_BASES)
        if pr is None:
            raise ValueError("the native parser rejected the input")
        for _chunk, B, Lp, max_out, n_cap, blob in pr[1]:
            yield B, Lp, max_out, n_cap, blob


def _chunk_n_positions(isn_idx, st, en, Lp):
    """Row-local device slots (bi*Lp + local) of N bases for a chunk,
    given the sorted whole-stream N-index array and per-row [st, en)
    code ranges.  Touches only rows that actually contain Ns."""
    lo = np.searchsorted(isn_idx, st)
    hi = np.searchsorted(isn_idx, en)
    if not len(isn_idx) or not (hi > lo).any():
        return np.empty(0, np.int64)
    parts = [
        bi * Lp + (isn_idx[l:h] - s0)
        for bi, (l, h, s0) in enumerate(zip(lo, hi, st))
        if h > l
    ]
    return np.concatenate(parts)


def _grow_if_overflow(
    pk, blob, B, Lp, n_cap, max_out, w, s, devcount=None, coff=-1,
    chunk_sids=None,
):
    """Given a fetched packed result, handle capacity overflow
    (pathological syncmer density) by re-running the same blob
    synchronously with a grown buffer instead of failing.  Under
    device-resident counting the fetched result is just the n_sel
    scalar slice, the overflowed chunk's key lanes are invalidated and
    the regrown keys appended (the global sort makes append order
    irrelevant)."""
    import jax
    import jax.numpy as jnp

    from ..kernels.syncmer import extract_hoco_fused

    while True:
        n_sel = int(pk[0]) if devcount is not None else int(pk[0, max_out])
        if n_sel <= max_out:
            return pk, n_sel, max_out
        old_max_out = max_out
        max_out = _round_up(n_sel + 1024, 1024)
        out = extract_hoco_fused(jnp.asarray(blob), B, Lp, n_cap, w, s, max_out)
        if devcount is not None:
            devcount.invalidate(coff, old_max_out)
            nsel_dev, coff = devcount.append(out["packed"], chunk_sids, Lp, max_out)
            pk = np.asarray(jax.device_get(nsel_dev))
        else:
            pk = np.asarray(jax.device_get(out["packed"]))


class _FetchBatcher:
    """One fetcher thread draining a queue of dispatched device outputs,
    fetching everything queued in ONE tree ``jax.device_get`` per drain.

    A tree transfer pays the per-copy fixed cost once for all ready
    chunks, and a single thread contends far less with the parse
    workers for the GIL than a fetch pool."""

    def __init__(self):
        import queue as _queue
        import threading

        self._q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, out):
        """Queue one kernel output dict; returns a Future -> np packed."""
        from concurrent.futures import Future

        fut: Future = Future()
        self._q.put((out, fut))
        return fut

    def close(self):
        self._q.put(None)
        self._thread.join()

    def _run(self):
        import queue as _queue

        import jax

        stop = False
        while not stop:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            while True:
                try:
                    nxt = self._q.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            try:
                res = jax.device_get([o["packed"] for o, _ in batch])
            except BaseException as e:  # surface in the consumer
                for _, f in batch:
                    f.set_exception(e)
                continue
            for (_, f), pk in zip(batch, res):
                f.set_result(np.asarray(pk))


def load_and_extract(
    paths: list[str],
    w: int,
    s: int,
    max_data: int = 0,
    batch_bases: int = _BATCH_BASES,
    device_count: bool = False,
) -> ReadDB | None:
    """Fused native load + device extraction: C parser/hoco/packer feeds
    :func:`oatk_tpu.kernels.syncmer.extract_hoco_fused` without
    materializing raw-ASCII records.

    Uncapped runs split each file at record boundaries and PIPELINE the
    host work against the device: worker threads parse+pack segment
    i+1 while segment i's blobs are uploaded and extracted on the
    device; the main thread only dispatches and fetches.
    -D capped runs keep the simple sequential flow.

    Returns None when the native library is unavailable or the input
    mixes FASTA and FASTQ records (the native parser rejects mixed
    buffers); the caller then falls back to read_fastx +
    extract_all_syncmers.
    """
    import jax
    import jax.numpy as jnp

    from .. import native
    from ..io.fastx import read_source_bytes
    from ..kernels.syncmer import extract_hoco_fused

    if not native.available():
        return None

    # device-resident counting (HOT LOOP 2 on device): keys accumulate
    # in carry buffers during extraction; collect_syncmer_db finalizes
    # with one device sort and fetches u32 ids instead of the khash row
    devcount = None
    if device_count and not max_data:
        from ..index.devcount import DevCountState

        devcount = DevCountState()

    db = ReadDB(k=w, s=s)
    total_raw = 0
    sid0 = 0
    code_parts: list[np.ndarray] = []
    rl_parts: list[np.ndarray] = []
    off_parts: list[np.ndarray] = []
    ovf_pos_parts: list[np.ndarray] = []
    ovf_len_parts: list[np.ndarray] = []
    off_base = 0
    import time as _time

    _tm: dict[str, float] = {}

    def _acc(key: str, t0: float) -> float:
        t1 = _time.perf_counter()
        _tm[key] = _tm.get(key, 0.0) + (t1 - t0)
        return t1

    def assemble(res, disp, keep, sid_base, flats=None):
        """Decode dispatched chunks of one parse unit into ReadSyncmers
        (entries beyond ``keep`` are skipped for the -D cap).  With
        ``flats`` = (codes_full, rl_full, base), hoco views point into
        the whole-file flat arrays (copied there by a worker thread)
        instead of the per-segment parse buffers."""
        names, rawlen, offs, codes, rl, isn_pos = res[:6]
        if flats is not None:
            codes_full, rl_full, vbase = flats
            codes = codes_full[vbase : vbase + int(offs[keep])]
            rl = rl_full[vbase : vbase + int(offs[keep])]
        reads: list = [None] * keep
        isn_views = _read_isn_views(isn_pos, offs, keep)
        if devcount is not None:
            # full-fetch mode: nothing to fetch here (n_sel scalars came
            # back in one batch before the finalize dispatch); the
            # m_pos/s_mer/k_mer views arrive with the finalize fetch
            # (DevCountState.build restores them per read)
            for ri in range(keep):
                o0, o1 = int(offs[ri]), int(offs[ri + 1])
                reads[ri] = ReadSyncmers(
                    sid=sid_base + ri,
                    name=names[ri],
                    hoco_l=o1 - o0,
                    hoco_code=codes[o0:o1],
                    ho_rl=rl[o0:o1],
                    is_n=isn_views[ri],
                    m_pos=None,
                    s_mer=None,
                    k_mer=None,
                )
            return reads
        for chunk, B, Lp, max_out, n_cap, blob, out, coff, _csids in disp:
            _t0 = _time.perf_counter()
            if hasattr(out, "result"):  # prefetched by the batcher thread
                pk, n_sel, max_out = _grow_if_overflow(
                    out.result(), blob, B, Lp, n_cap, max_out, w, s,
                )
            else:
                pk = np.asarray(jax.device_get(out["packed"]))
                pk, n_sel, max_out = _grow_if_overflow(
                    pk, blob, B, Lp, n_cap, max_out, w, s,
                )
            _acc("fetch", _t0)
            _tm.setdefault("fetch_each", []).append(  # type: ignore[union-attr]
                round((_time.perf_counter() - _t0) * 1000, 1)
            ) if _timeit_enabled() else None
            sel_b, sel_p, sel_z, sel_smer, sel_kh = _unpack_packed(pk, n_sel, Lp)
            cuts = np.searchsorted(sel_b, np.arange(B + 1))
            # whole-chunk field computation, then per-read views
            mpos_all = (sel_p.astype(np.uint32) << 1) | sel_z.astype(np.uint32)
            smer_all = sel_smer.astype(np.uint64)
            kmer_all = sel_kh.copy() if sel_kh is not None else None
            for bi, ri in enumerate(chunk):
                if ri >= keep:
                    continue
                lo, hi = cuts[bi], cuts[bi + 1]
                o0, o1 = int(offs[ri]), int(offs[ri + 1])
                reads[ri] = ReadSyncmers(
                    sid=sid_base + ri,
                    name=names[ri],
                    hoco_l=o1 - o0,
                    hoco_code=codes[o0:o1],
                    ho_rl=rl[o0:o1],
                    is_n=isn_views[ri],
                    m_pos=mpos_all[lo:hi],
                    s_mer=smer_all[lo:hi],
                    k_mer=kmer_all[lo:hi] if kmer_all is not None else None,
                )
        return reads

    if devcount is not None and len(paths) > 1:
        # pre-size across ALL inputs before the first append allocates
        # the buffers: the per-file hint below is a no-op once _bufs
        # exists, so a multi-file run would otherwise overflow and pay a
        # growth recompile per extra file (sizes unknowable for
        # pipes/URLs are skipped; the overflow path still covers them)
        import os as _osp

        tot = 0
        for p in paths:
            try:
                sz = _osp.path.getsize(p)
            except (OSError, ValueError):
                sz = 0
            tot += expected_key_lanes(sz, w, s)
        devcount.cap_hint = max(devcount.cap_hint, tot)

    for path in paths:
        _t0 = _time.perf_counter()
        data = read_source_bytes(path)
        _acc("read_bytes", _t0)
        if devcount is not None:
            # pre-size the device count buffers from the input volume; a
            # growth step would compile a fresh (max_out, cap) append
            # program
            est = devcount.n_fill + expected_key_lanes(len(data), w, s)
            devcount.cap_hint = max(devcount.cap_hint, est)

        if not max_data:
            # ---- pipelined flow (no -D cap) ----
            from concurrent.futures import ThreadPoolExecutor

            # fixed ~4 MB segments regardless of file size: segment row
            # counts (and so the padded XLA batch shapes) stay in the
            # same small vocabulary for ANY dataset, so a new input
            # reuses cached programs instead of paying a first compile
            # per new shape.  Smaller first segment also starts the
            # device pipeline sooner.
            n_seg = max(1, len(data) // _SEG_BYTES)
            # fetch batcher: chunk results stream back on ONE thread in
            # tree-batched device_get drains (a fixed per-copy cost
            # dominates these ~0.2 MB results)
            fetch_pool = ThreadPoolExecutor(1)  # mixed-format guard scan
            batcher = _FetchBatcher()
            # whole-file hoco arrays: each segment parses DIRECTLY into
            # its own byte-range region (hoco length never exceeds raw
            # bytes, so regions are disjoint).  The regions are NOT
            # compacted afterwards -- hoco_off simply points at each
            # read's true position, leaving a gap after every segment
            # where its hoco shrank.  Every consumer addresses the
            # streams as hoff[sid]+pos windows inside one read (native
            # consensus/EC take per-read lengths separately), so
            # inter-read gaps are invisible, and the buffers are
            # allocated at len(data) either way -- the old leftward
            # memmove compaction was ~2 s of pure copy (plus microVM
            # fault tax) per Gbp.  Ambiguous positions are sparse
            # parser outputs; no dense isn buffer exists at all.
            codes_full = np.empty(len(data), np.uint8)
            rl_full = np.empty(len(data), np.uint8)
            failed = False
            seg_results: list = []
            for attempt in (0, 1):
                _t0 = _time.perf_counter()
                guard_fut = None
                cuts = None
                if n_seg > 1:
                    if attempt == 0 and data[:1] == b">":
                        # optimistic: split on '\n>' now; the mixed-format
                        # guard scan runs concurrently on a worker thread
                        # instead of gating the whole pipeline
                        cuts = native.fasta_record_cuts(data, n_seg)
                        if cuts is not None:
                            guard_fut = fetch_pool.submit(
                                native.find_pattern2, data, b"\n@"
                            )
                    else:
                        cuts = native.segment_record_cuts(data, n_seg)
                bounds = _segment_bounds(data, cuts)
                _t0 = _acc("cuts", _t0)
                seg_results = []
                failed = False
                # key lanes appended during a discarded attempt must be
                # masked out of the device count buffers
                att_fill = devcount.n_fill if devcount is not None else 0
                seg_sid = sid0
                # parse workers honor the -t / OATK_TPU_THREADS width.
                # Cap 8: the C parse releases the GIL and the AVX-512
                # packer cut the GIL-side pack share to ~9% of parse
                # CPU (3 Gbp warm: pack_work 2.4 s vs parse_work 26 s),
                # so ~8 workers fit before the GIL serializes; parse is
                # the binding term at Gbp scale on many-core hosts.
                n_parse = max(1, min(native.n_threads_default(), 8, len(bounds)))
                seg_tms: list = []  # (parse_s, pack_s) per segment, worker-side
                with ThreadPoolExecutor(n_parse) as ex:
                    futs = [
                        ex.submit(
                            _parse_pack_segment, data, c0, c1, w, s, batch_bases,
                            (codes_full[c0:c1], rl_full[c0:c1]), seg_tms,
                        )
                        for c0, c1 in bounds
                    ]
                    for (c0, _c1), fut in zip(bounds, futs):
                        # consume in order; dispatch as ready
                        _t0 = _time.perf_counter()
                        pr = fut.result()
                        _t0 = _acc("parse_wait", _t0)
                        if pr is None:
                            failed = True
                            continue
                        res, chunks = pr
                        disp = []
                        for (chunk, B, Lp, max_out, n_cap, blob) in chunks:
                            out = extract_hoco_fused(
                                jnp.asarray(blob), B, Lp, n_cap, w, s, max_out,
                            )
                            coff = -1
                            csids = None
                            if devcount is not None:
                                csids = np.asarray(chunk, np.int64) + seg_sid
                                nsel_dev, coff = devcount.append(
                                    out["packed"], csids, Lp, max_out,
                                )
                                # n_sel scalars are batch-fetched in ONE
                                # copy after the segment loop instead of
                                # one synchronizing drain per chunk
                                out = {"packed": nsel_dev}
                                fut = out
                            else:
                                fut = batcher.submit(out)
                            disp.append((
                                chunk, B, Lp, max_out, n_cap, blob,
                                fut, coff, csids,
                            ))
                        _acc("dispatch", _t0)
                        seg_sid += len(res[0])
                        # the segment's reads live at [c0, c0+h_end) of
                        # the whole-file arrays (parse wrote in place)
                        seg_results.append((res, disp, c0))
                if guard_fut is not None and guard_fut.result() >= 0:
                    # rare mixed-format file: the optimistic '\n>' split
                    # was unsafe; drain in-flight work and redo verified
                    for _res, _disp, _b in seg_results:
                        for item in _disp:
                            try:
                                if hasattr(item[6], "result"):
                                    item[6].result()
                            except Exception:
                                pass
                    if devcount is not None and devcount.n_fill > att_fill:
                        devcount.invalidate(att_fill, devcount.n_fill - att_fill)
                    continue
                break
            if seg_tms:
                _tm["parse_work"] = _tm.get("parse_work", 0.0) + sum(
                    p for p, _ in seg_tms
                )
                _tm["pack_work"] = _tm.get("pack_work", 0.0) + sum(
                    q for _, q in seg_tms
                )
            if failed:
                fetch_pool.shutdown(wait=True)
                batcher.close()
                return None
            if devcount is not None and devcount.n_fill > 0:
                # dispatch the finalize sort OPTIMISTICALLY, before the
                # n_sel scalars are even drained: overflow is
                # pathological-rare, and when it does happen the regrow
                # below clears the stale result and a re-dispatch picks
                # up the corrected buffers.  This moves the entire
                # device queue (extract kernels + finalize sort) behind
                # the host read assembly.
                devcount.start_finalize()
            _t0 = _time.perf_counter()
            for res, disp, vbase in seg_results:
                names, rawlen, offs = res[0], res[1], res[2]
                keep = len(names)
                db.reads.extend(
                    assemble(res, disp, keep, sid0, (codes_full, rl_full, vbase))
                )
                total_raw += int(rawlen.sum())
                off_parts.append(offs[:keep] + (off_base + vbase))
                if len(res[6]):
                    # run-length overflow entries: segment-local -> global
                    ovf_pos_parts.append(res[6] + (off_base + vbase))
                    ovf_len_parts.append(res[7])
                sid0 += keep
            off_base += len(data)
            code_parts.append(codes_full)
            rl_parts.append(rl_full)
            _t0 = _acc("assemble_total", _t0)
            if devcount is not None:
                # ONE copy for every chunk's n_sel overflow
                # scalar, drained AFTER assembly: the wait for the
                # device queue (uploads + extract kernels + finalize
                # sort) overlapped the host assembly above, so this
                # fetch usually lands on finished work.
                # Rare overflows regrow here; the regrow invalidates
                # the optimistic finalize and the next start_finalize
                # re-dispatches over settled buffers.
                items = [it for _res, dsp, _vb in seg_results for it in dsp]
                if items:
                    nsel_arrs = jax.device_get(
                        [it[6]["packed"] for it in items]
                    )
                    for it, nv in zip(items, nsel_arrs):
                        chunk, B, Lp, max_out, n_cap, blob, _o, coff, csids = it
                        _pk, n_sel, _mo = _grow_if_overflow(
                            np.asarray(nv), blob, B, Lp, n_cap, max_out,
                            w, s, devcount, coff, csids,
                        )
                        devcount.n_occ += n_sel
                _t0 = _acc("nsel_fetch", _t0)
            fetch_pool.shutdown(wait=True)
            batcher.close()
            _acc("pool_shutdown", _t0)
            continue

        # ---- sequential flow (-D cap honored mid-file) ----
        res = native.parse_fastx_hoco_mt(data)
        if res is None:
            return None
        names, rawlen, offs, codes, rl, isn_idx = res[:6]
        n_reads = len(names)
        hoco_l = (offs[1:] - offs[:-1]).astype(np.int64)

        # honor the data cap (-D)
        cum = np.cumsum(rawlen)
        keep = int(np.searchsorted(cum, max_data - total_raw) + 1)
        keep = min(keep, n_reads)
        total_raw += int(rawlen[:keep].sum())

        # bucket by padded hoco length
        buckets: dict[int, list[int]] = {}
        for i in range(keep):
            L = max(int(hoco_l[i]), w + 4)
            Lp = _bucket_len(L)
            buckets.setdefault(Lp, []).append(i)

        disp = []
        for Lp, idxs in sorted(buckets.items()):
            bsz = max(1, batch_bases // Lp)
            for start in range(0, len(idxs), bsz):
                chunk = idxs[start : start + bsz]
                B = _pad_rows(len(chunk), bsz)
                max_out = _round_up(
                    max(1024, int(B * Lp / _sel_divisor(w, s))), 1024
                )
                st = offs[chunk]
                en = offs[np.asarray(chunk) + 1]
                n_pos = _chunk_n_positions(isn_idx, st, en, Lp)
                n_cap = 0 if not len(n_pos) else _round_up(max(64, len(n_pos)), 1024)
                blob, packed, hl = _new_blob(B, Lp, n_cap, n_pos)
                native.pack_rows_gather(codes, st, en, Lp // 4, out=packed)
                hl[: len(chunk)] = (en - st).astype(np.int32)
                out = extract_hoco_fused(
                    jnp.asarray(blob), B, Lp, n_cap, w, s, max_out,
                )
                disp.append((chunk, B, Lp, max_out, n_cap, blob, out, -1, None))

        db.reads.extend(assemble(res, disp, keep, sid0))
        h_end = int(offs[keep])
        code_parts.append(codes[:h_end])
        rl_parts.append(rl[:h_end])
        off_parts.append(offs[:keep] + off_base)
        if len(res[6]):
            sel = res[6] < h_end  # entries of reads beyond the -D cap drop
            ovf_pos_parts.append(res[6][sel] + off_base)
            ovf_len_parts.append(res[7][sel])
        off_base += h_end
        sid0 += keep
        if total_raw >= max_data:
            # message as /root/reference/syncmer.c:473,539
            log_info(
                f"data limit ({max_data}) reached. Discard the remaining sequences...",
                func="sr_read",
            )
            break
    if code_parts:
        db.hoco_flat = (
            code_parts[0] if len(code_parts) == 1 else np.concatenate(code_parts)
        )
        db.rl_flat = rl_parts[0] if len(rl_parts) == 1 else np.concatenate(rl_parts)
        z = np.zeros(0, np.int64)
        db.rl_ovf_pos = np.concatenate(ovf_pos_parts) if ovf_pos_parts else z
        db.rl_ovf_len = np.concatenate(ovf_len_parts) if ovf_len_parts else z
        db.hoco_off = np.concatenate(
            off_parts + [np.asarray([off_base], np.int64)]
        ).astype(np.int64, copy=False)
    if devcount is not None and devcount.n_fill > 0:
        # dispatch the device sort now and start its outputs' async
        # device->host copies: sort + transfer overlap the host work
        # between here and collect_syncmer_db's (then-cheap) device_get
        devcount.start_finalize()
        devcount.prefetch(len(db.reads))
        db._devcount = devcount  # consumed by collect_syncmer_db
    # always exported: the bench's load_extract sub-split (wall-view
    # phases on the main thread + worker-side parse/pack CPU sums)
    db.load_timings = {
        k_: v for k_, v in _tm.items() if not isinstance(v, list)
    }
    if _timeit_enabled() and _tm:
        import sys as _sys

        parts = " ".join(
            f"{k_}={v}" if isinstance(v, list) else f"{k_}={v * 1000:.1f}ms"
            for k_, v in _tm.items()
        )
        print(f"[T::load_and_extract] {parts}", file=_sys.stderr, flush=True)
    return db
