"""Native (C) runtime components with lazy build + Python fallback.

The reference's runtime is C (kseq parsing, pthread pools); this
rebuild keeps device compute in XLA but moves the host-side data
plumbing (FASTA/FASTQ parse + homopolymer compression +
2-bit packing) into a small C library, built on demand with the system
compiler and loaded via ctypes.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libfastx_hoco.so")
_SRCS = [
    os.path.join(_HERE, "fastx_hoco.c"),
    os.path.join(_HERE, "wavefront.c"),
    os.path.join(_HERE, "consensus.c"),
    os.path.join(_HERE, "align.c"),
    os.path.join(_HERE, "ec.c"),
    os.path.join(_HERE, "sort.c"),
    os.path.join(_HERE, "graph_build.c"),
]
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        src_mtime = max(os.path.getmtime(s) for s in _SRCS)
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < src_mtime:
            cc = os.environ.get("CC", "cc")
            # per-process temp name: concurrent first uses (test
            # workers) each build and atomically publish the library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-pthread", *_SRCS, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.parse_fastx_hoco.restype = ctypes.c_int64
        lib.parse_fastx_hoco.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.pack_rows.restype = None
        lib.pack_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.pack_rows_gather.restype = None
        lib.pack_rows_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.wf_ed_core_native.restype = ctypes.c_int64
        lib.wf_ed_core_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.scm_overlap_mode.restype = ctypes.c_int64
        lib.scm_overlap_mode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.utg_consensus_emit.restype = ctypes.c_int64
        lib.utg_consensus_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.utg_consensus_emit_batch.restype = ctypes.c_int64
        lib.utg_consensus_emit_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.arc_overlap_batch.restype = ctypes.c_int64
        lib.arc_overlap_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.scm_consensus_fill.restype = ctypes.c_int64
        lib.scm_consensus_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.align_batch.restype = ctypes.c_int64
        lib.align_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.find_lcs.restype = ctypes.c_int64
        lib.find_lcs.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ma_blocks.restype = ctypes.c_int64
        lib.ma_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.ma_blocks_batch.restype = ctypes.c_int64
        lib.ma_blocks_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.ec_correct_reads.restype = ctypes.c_int64
        lib.ec_correct_reads.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.count_byte2.restype = ctypes.c_int64
        lib.count_byte2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8, ctypes.c_uint8,
        ]
        lib.find_byte2.restype = ctypes.c_int64
        lib.find_byte2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8, ctypes.c_uint8,
        ]
        lib.radix_sort_u64.restype = ctypes.c_int
        lib.radix_sort_u64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.radix_argsort_u64.restype = ctypes.c_int
        lib.radix_argsort_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.graph_build_arcs.restype = ctypes.c_int
        lib.graph_build_arcs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.graph_index_link.restype = ctypes.c_int
        lib.graph_index_link.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        _lib = lib
    except Exception:
        _build_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def count_header_marks(data: bytes, start: int = 0, end: int | None = None) -> int:
    """GIL-free upper bound on the record count in data[start:end]: the
    leading byte fixes the format, so only that header marker needs
    counting (FASTQ quality lines starting with '@' merely inflate the
    bound).  One native memchr scan instead of bytes.count (which holds
    the GIL and would serialize the parse worker threads)."""
    lib = _load()
    if end is None:
        end = len(data)
    n = end - start
    buf = np.frombuffer(data, np.uint8)
    p = buf.ctypes.data + start
    lead = data[start : start + 1]
    if lead == b">":
        return int(lib.count_byte2(p, n, 10, ord(">"))) + 2
    if lead == b"@":
        return int(lib.count_byte2(p, n, 10, ord("@"))) + 2
    return (
        int(lib.count_byte2(p, n, 10, ord(">")))
        + int(lib.count_byte2(p, n, 10, ord("@")))
        + 2
    )


def find_pattern2(data: bytes, pat: bytes, start: int = 0, end: int | None = None) -> int:
    """First index of a 2-byte pattern in data[start:end] (absolute), or
    -1.  Runs without the GIL (native memchr scan)."""
    lib = _load()
    if end is None:
        end = len(data)
    buf = np.frombuffer(data, np.uint8)
    r = int(lib.find_byte2(buf.ctypes.data + start, end - start, pat[0], pat[1]))
    return r + start if r >= 0 else -1


def parse_fastx_hoco(data: bytes, start: int = 0, end: int | None = None, out=None):
    """Parse + hoco-compress a FASTA/FASTQ byte range natively.

    ``start``/``end`` bound the parse to data[start:end] WITHOUT copying
    the segment (the pipelined loader splits one big buffer into ~4 MB
    segments; slicing bytes would memcpy the whole file again).

    ``out`` = (codes[u8], rl[u8]) contiguous arrays of length
    >= end-start: parse straight into caller storage (the loader hands
    disjoint regions of its whole-file arrays, skipping the per-segment
    allocation page-faults AND the copy-out).

    Returns (names, rawlen[i64], offs[i64 n+1], codes[u8],
    rl[u8 run-length-1 saturated at 255], isn_pos[i64], ovf_pos[i64],
    ovf_len[i64]) with per-read hoco streams concatenated (views of
    ``out`` when given); isn_pos holds the sorted hoco positions of
    ambiguous bases (sparse: Ns are rare, a dense flag array costs
    1 GB/Gbp of peak RSS) and (ovf_pos, ovf_len) the sorted exact
    run-length-1 entries for every saturated position (both local to
    this call's output), or None when the native library is
    unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    if end is None:
        end = len(data)
    n = end - start
    max_reads = max(16, count_header_marks(data, start, end))
    max_hoco = n  # hoco never exceeds raw length
    if out is not None:
        codes, rl = out
    else:
        codes = np.empty(max_hoco, np.uint8)
        rl = np.empty(max_hoco, np.uint8)
    offs = np.empty(max_reads + 1, np.int64)
    rawlen = np.empty(max_reads, np.int64)
    hdr_beg = np.empty(max_reads, np.int64)
    hdr_end = np.empty(max_reads, np.int64)
    buf = np.frombuffer(data, np.uint8)
    max_ovf = 1024
    max_isn = 4096
    while True:
        n_hoco = ctypes.c_int64(0)
        n_ovf = ctypes.c_int64(0)
        n_isn = ctypes.c_int64(0)
        ovf_pos = np.empty(max_ovf, np.int64)
        ovf_len = np.empty(max_ovf, np.int64)
        isn_pos = np.empty(max_isn, np.int64)
        ret = lib.parse_fastx_hoco(
            buf.ctypes.data + start, n,
            codes.ctypes.data, rl.ctypes.data,
            isn_pos.ctypes.data, max_isn, ctypes.byref(n_isn),
            offs.ctypes.data, rawlen.ctypes.data,
            hdr_beg.ctypes.data, hdr_end.ctypes.data,
            max_reads, max_hoco, ctypes.byref(n_hoco),
            ovf_pos.ctypes.data, ovf_len.ctypes.data, max_ovf,
            ctypes.byref(n_ovf),
        )
        if ret == -3:
            max_ovf *= 8  # freak homopolymer density: regrow and re-parse
            continue
        if ret == -4:
            max_isn *= 8  # N-dense input: regrow and re-parse
            continue
        break
    if ret < 0:
        return None
    n_reads = int(ret)
    h = int(n_hoco.value)
    no = int(n_ovf.value)
    ni = int(n_isn.value)
    names = [
        data[start + hdr_beg[i] : start + hdr_end[i]].decode() for i in range(n_reads)
    ]
    return (names, rawlen[:n_reads], offs[: n_reads + 1].copy(),
            codes[:h], rl[:h], isn_pos[:ni], ovf_pos[:no], ovf_len[:no])


def segment_record_cuts(data: bytes, n_seg: int):
    """Record-boundary byte cuts splitting a FASTA/FASTQ buffer into up
    to n_seg segments, or None when a safe split cannot be proven
    (mixed/odd formats -> caller treats the buffer as one segment).

    FASTA splits at '\\n>' (unambiguous when no '\\n@' occurs anywhere:
    headers are '>' and sequence lines hold bases).  FASTQ records are
    exactly 4 lines for this parser, so every 4th newline ends a
    record; quality bytes can be '@'/'>' so only line counting is safe."""
    if n_seg <= 1:
        return None
    if data[:1] == b">" and find_pattern2(data, b"\n@") < 0:
        return fasta_record_cuts(data, n_seg)
    if data[:1] == b"@":
        nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
        n_lines = len(nl) + (0 if data[-1:] == b"\n" else 1)
        if n_lines % 4 != 0 and not data[-1:] == b"\n":
            return None
        n_rec = n_lines // 4
        if n_rec < n_seg * 2:
            return None
        cuts = [0]
        for t in range(1, n_seg):
            rec = n_rec * t // n_seg
            p = int(nl[rec * 4 - 1]) + 1
            if p <= cuts[-1] or p >= len(data):
                continue
            if data[p : p + 1] != b"@":
                return None
            cuts.append(p)
        cuts.append(len(data))
        return cuts if len(cuts) > 2 else None
    return None


def fasta_record_cuts(data: bytes, n_seg: int):
    """'\\n>'-boundary byte cuts of a FASTA buffer WITHOUT the mixed-
    format guard scan.  The pipelined loader uses this optimistically
    and validates `find_pattern2(data, b"\\n@") < 0` concurrently on a
    worker thread (falling back to an unsplit parse on the rare hit),
    keeping the 1-pass guard scan off the critical path."""
    cuts = [0]
    step = len(data) // n_seg
    for t in range(1, n_seg):
        p = data.find(b"\n>", max(cuts[-1], t * step))
        if p < 0:
            break
        cuts.append(p + 1)
    cuts.append(len(data))
    return cuts if len(cuts) > 2 else None


def parse_fastx_hoco_mt(data: bytes, n_threads: int | None = None):
    """Threaded FASTA parse+hoco: the byte buffer splits at record
    boundaries (:func:`segment_record_cuts`) and ctypes releases the
    GIL during each C call, so segments parse in parallel.  Unsplittable
    buffers fall back to the single-thread parser.  Same output contract
    as :func:`parse_fastx_hoco`."""
    if _load() is None:
        return None
    if n_threads is None:
        n_threads = n_threads_default()
    if n_threads <= 1 or len(data) < (4 << 20):
        return parse_fastx_hoco(data)
    cuts = segment_record_cuts(data, n_threads)
    if cuts is None or len(cuts) <= 2:
        return parse_fastx_hoco(data)
    bounds = [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(bounds)) as ex:
        parts = list(ex.map(lambda be: parse_fastx_hoco(data, be[0], be[1]), bounds))
    if any(p is None for p in parts):
        return parse_fastx_hoco(data)
    names = []
    for p in parts:
        names.extend(p[0])
    rawlen = np.concatenate([p[1] for p in parts])
    codes = np.concatenate([p[3] for p in parts])
    rlv = np.concatenate([p[4] for p in parts])
    offs = np.empty(len(names) + 1, np.int64)
    offs[0] = 0
    pos = 0
    base = 0
    isn_pos_parts = []
    ovf_pos_parts = []
    ovf_len_parts = []
    for p in parts:
        seg_offs = p[2]
        n = len(p[0])
        offs[pos + 1 : pos + n + 1] = seg_offs[1:] + base
        if len(p[5]):
            isn_pos_parts.append(p[5] + base)
        if len(p[6]):
            ovf_pos_parts.append(p[6] + base)
            ovf_len_parts.append(p[7])
        base += seg_offs[-1]
        pos += n
    z = np.zeros(0, np.int64)
    isn_pos = np.concatenate(isn_pos_parts) if isn_pos_parts else z
    ovf_pos = np.concatenate(ovf_pos_parts) if ovf_pos_parts else z
    ovf_len = np.concatenate(ovf_len_parts) if ovf_len_parts else z
    return names, rawlen, offs, codes, rlv, isn_pos, ovf_pos, ovf_len


def wf_ed_core_native(ts, qs, is_ext: int, bw: int, hdr, k) -> int:
    """Run the wavefront core natively; see native/wavefront.c.

    ts, qs: contiguous uint8 arrays; hdr: int64[5]
    {score, t_end_raw, q_end_raw, d0, n}; k: int64 capacity buffer.
    Returns 1 end-hit / 0 band-exceeded / -1 capacity too small."""
    lib = _load()
    return lib.wf_ed_core_native(
        ts.ctypes.data, len(ts), qs.ctypes.data, len(qs),
        is_ext, bw, hdr.ctypes.data, k.ctypes.data, len(k),
    )


def utg_consensus_emit(
    v, w: int, hoco_seq: bool, mp_flat, mp_off, kflat, mflat, moff,
    code_flat, rl_flat, hoff, out, rl_ovf=None,
) -> int:
    lib = _load()
    op, ol, no = _rl_ovf_ptrs(rl_ovf)
    return lib.utg_consensus_emit(
        v.ctypes.data, len(v), w, 1 if hoco_seq else 0,
        mp_flat.ctypes.data, mp_off.ctypes.data,
        kflat.ctypes.data, mflat.ctypes.data, moff.ctypes.data,
        code_flat.ctypes.data, rl_flat.ctypes.data, hoff.ctypes.data,
        op, ol, no,
        len(code_flat), out.ctypes.data, len(out),
    )


def utg_consensus_emit_batch(
    va_flat, va_off, live, w: int, hoco_seq: bool, mp_flat, mp_off,
    kflat, mflat, moff, code_flat, rl_flat, hoff, out, cuts,
    n_threads: int | None = None, rl_ovf=None,
) -> int:
    lib = _load()
    if n_threads is None:
        n_threads = n_threads_default()
    op, ol, no = _rl_ovf_ptrs(rl_ovf)
    return lib.utg_consensus_emit_batch(
        va_flat.ctypes.data, va_off.ctypes.data,
        live.ctypes.data, len(live),
        w, 1 if hoco_seq else 0,
        mp_flat.ctypes.data, mp_off.ctypes.data,
        kflat.ctypes.data, mflat.ctypes.data, moff.ctypes.data,
        code_flat.ctypes.data, rl_flat.ctypes.data, hoff.ctypes.data,
        op, ol, no,
        len(code_flat), n_threads,
        out.ctypes.data, len(out), cuts.ctypes.data,
    )


def arc_overlap_batch(
    av, aw, aln, adel, acomp, va_flat, va_off, vtx_len, w: int,
    hoco_seq: bool, mp_flat, mp_off, kflat, mflat, moff,
    code_flat, rl_flat, hoff, scratch_cap: int, out_als, rl_ovf=None,
    n_threads: int | None = None,
) -> int:
    """Workers allocate their own scratch of ``scratch_cap`` bytes (the
    C pointer arg is vestigial); returns 0 ok, -1 scratch too small
    (caller regrows), -2 worker allocation failure (fatal)."""
    lib = _load()
    if n_threads is None:
        n_threads = n_threads_default()
    op, ol, no = _rl_ovf_ptrs(rl_ovf)
    return lib.arc_overlap_batch(
        av.ctypes.data, aw.ctypes.data, aln.ctypes.data,
        adel.ctypes.data, acomp.ctypes.data, len(av),
        va_flat.ctypes.data, va_off.ctypes.data, vtx_len.ctypes.data,
        w, 1 if hoco_seq else 0,
        mp_flat.ctypes.data, mp_off.ctypes.data,
        kflat.ctypes.data, mflat.ctypes.data, moff.ctypes.data,
        code_flat.ctypes.data, rl_flat.ctypes.data, hoff.ctypes.data,
        op, ol, no,
        len(code_flat), None, scratch_cap, out_als.ctypes.data,
        n_threads,
    )


def scm_overlap_mode(pos1, pos2, rc1: int, rc2: int, kflat, mflat, moff) -> int:
    lib = _load()
    return lib.scm_overlap_mode(
        pos1.ctypes.data, len(pos1), pos2.ctypes.data, len(pos2),
        rc1, rc2, kflat.ctypes.data, mflat.ctypes.data, moff.ctypes.data,
    )


def scm_consensus_fill(
    mpos, rev: int, beg: int, l: int, kflat, mflat, moff,
    code_flat, rl_flat, hoff, need_rl: bool, base_out, totrl_out,
    rl_ovf=None,
) -> int:
    lib = _load()
    op, ol, no = _rl_ovf_ptrs(rl_ovf)
    return lib.scm_consensus_fill(
        mpos.ctypes.data, len(mpos), rev, beg, l,
        kflat.ctypes.data, mflat.ctypes.data, moff.ctypes.data,
        code_flat.ctypes.data, rl_flat.ctypes.data, hoff.ctypes.data,
        op, ol, no,
        1 if need_rl else 0, len(code_flat), base_out.ctypes.data,
        totrl_out.ctypes.data if totrl_out is not None else None,
    )


def _rl_ovf_ptrs(rl_ovf):
    """(ptr, ptr, n) for an optional (ovf_pos, ovf_len) run-length
    overflow pair (u8 rl stores run-1 saturated at 255)."""
    if rl_ovf is None or len(rl_ovf[0]) == 0:
        return None, None, 0
    op, ol = rl_ovf
    return op.ctypes.data, ol.ctypes.data, len(op)


_n_threads_override = 0


def set_threads(n: int) -> None:
    """Explicit pool width for every native threaded stage (the CLI
    ``-t`` plumbed end-to-end, /root/reference/run_syncasm.c:360,381
    semantics: one value governs parse, align, EC, sorts).  0 restores
    the automatic default (OATK_TPU_THREADS env, else cpu_count)."""
    global _n_threads_override
    _n_threads_override = max(0, int(n))


def n_threads_default() -> int:
    if _n_threads_override:
        return _n_threads_override
    env = os.environ.get("OATK_TPU_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(8, os.cpu_count() or 1))


def argsort_u64(keys: np.ndarray, n_threads: int | None = None) -> np.ndarray | None:
    """Stable argsort of a uint64 array (threaded LSD radix); None when
    the native library is unavailable (callers use np.argsort)."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = n_threads_default()
    keys = np.ascontiguousarray(keys, np.uint64)
    out = np.empty(len(keys), np.int64)
    if lib.radix_argsort_u64(keys.ctypes.data, len(keys), out.ctypes.data, n_threads) != 0:
        return None
    return out


def graph_build_arcs(pk: np.ndarray, sc: np.ndarray, n_threads: int | None = None):
    """Threaded dup-free arc construction for make_syncmer_graph.

    pk: sorted unique canonical pair keys (u64 s0<<32|s1); sc: int64
    counts.  Returns None when the native library is unavailable,
    ("dup",) when duplicate keys require the generic finalize path, or
    (av, aw, acov, acomp, partner) views of length total otherwise --
    the exact arrays the Python dup_free branch in asm/scg.py builds.
    """
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = n_threads_default()
    pk = np.ascontiguousarray(pk, np.uint64)
    sc = np.ascontiguousarray(sc, np.int64)
    nf = len(pk)
    cap = 2 * nf
    av = np.empty(cap, np.uint64)
    aw = np.empty(cap, np.uint64)
    acov = np.empty(cap, np.int64)
    acomp = np.zeros(cap, bool)
    partner = np.empty(cap, np.int64)
    total = ctypes.c_int64(0)
    rc = lib.graph_build_arcs(
        pk.ctypes.data, sc.ctypes.data, nf,
        av.ctypes.data, aw.ctypes.data, acov.ctypes.data,
        acomp.ctypes.data, partner.ctypes.data,
        ctypes.byref(total), n_threads,
    )
    if rc == 1:
        return ("dup",)
    if rc != 0:
        return None
    t = total.value
    return (av[:t], aw[:t], acov[:t], acomp[:t], partner[:t])


def graph_index_link(av: np.ndarray, partner: np.ndarray, n_dir: int,
                     n_threads: int | None = None):
    """Combined arc_index + shrink_link_id for bulk-built graphs (sorted
    av + known complement partners).  Returns (idx_p, idx_n, alink) or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = n_threads_default()
    av = np.ascontiguousarray(av, np.uint64)
    partner = np.ascontiguousarray(partner, np.int64)
    n = len(av)
    idx_p = np.zeros(n_dir, np.int64)
    idx_n = np.zeros(n_dir, np.int64)
    alink = np.empty(n, np.uint64)
    if lib.graph_index_link(
        av.ctypes.data, partner.ctypes.data, n, n_dir,
        idx_p.ctypes.data, idx_n.ctypes.data, alink.ctypes.data, n_threads,
    ) != 0:
        return None
    return idx_p, idx_n, alink


def sort_u64(keys: np.ndarray, n_threads: int | None = None) -> bool:
    """In-place ascending sort of a contiguous uint64 array; False when
    the native library is unavailable (callers use ndarray.sort)."""
    lib = _load()
    if lib is None:
        return False
    if n_threads is None:
        n_threads = n_threads_default()
    assert keys.dtype == np.uint64 and keys.flags.c_contiguous
    return lib.radix_sort_u64(keys.ctypes.data, len(keys), n_threads) == 0


def align_batch(
    uid, upos, spos, aoff, n_scm, min_score, ulen, arc_key, arc_aln,
    n_threads: int | None = None,
):
    """Batched read->graph fragment chaining (native/align.c), run on a
    work-stealing thread pool over reads (kt_for analogue).

    Anchors pre-sorted per read by (uid, spos, upos), reads delimited by
    aoff.  Returns (frags[N,6] i64, chain_cut, read_cut, max_score) or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = n_threads_default()
    n_reads = len(aoff) - 1
    cap_frag = max(4096, 4 * len(uid) + 64)
    cap_chain = max(1024, 2 * n_reads + 64)
    while True:
        out_frag = np.empty((cap_frag, 6), np.int64)
        chain_cut = np.empty(cap_chain + 1, np.int64)
        read_cut = np.empty(n_reads + 1, np.int64)
        max_score = np.empty(n_reads, np.int64)
        ret = lib.align_batch(
            uid.ctypes.data, upos.ctypes.data, spos.ctypes.data,
            aoff.ctypes.data, n_reads,
            n_scm.ctypes.data, min_score.ctypes.data, ulen.ctypes.data,
            arc_key.ctypes.data, arc_aln.ctypes.data, len(arc_key),
            n_threads,
            out_frag.ctypes.data, chain_cut.ctypes.data,
            read_cut.ctypes.data, max_score.ctypes.data,
            cap_frag, cap_chain,
        )
        if ret == -2:
            raise MemoryError("align_batch: allocation failure")
        if ret >= 0:
            n_chain = int(read_cut[n_reads])
            return (
                out_frag[: int(ret)],
                chain_cut[: n_chain + 1],
                read_cut,
                max_score,
            )
        cap_frag *= 4
        cap_chain *= 4


def ma_blocks_native(scm, frag6, aln_cut, va_flat, va_off):
    """Multi-alignment blocks for one read (native/align.c ma_blocks).

    Returns (n_match[i64 nb], uids[nb, n_aln]) or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n_aln = len(aln_cut) - 1
    cap = 64 + 2 * len(scm)
    while True:
        out_nm = np.empty(cap, np.int64)
        out_u = np.empty((cap, max(1, n_aln)), np.int64)
        ret = lib.ma_blocks(
            scm.ctypes.data, len(scm),
            frag6.ctypes.data, aln_cut.ctypes.data, n_aln,
            va_flat.ctypes.data, va_off.ctypes.data,
            out_nm.ctypes.data, out_u.ctypes.data, cap,
        )
        if ret == -2:
            raise MemoryError("ma_blocks: allocation failure")
        if ret >= 0:
            nb = int(ret)
            return out_nm[:nb], out_u[:nb]
        cap *= 4


def ma_blocks_batch_native(
    scm_flat, scm_off, frag6, aln_cut, read_aln_off, va_flat, va_off,
    n_threads: int | None = None,
):
    """Multi-alignment blocks for ALL reads in one threaded native call
    (native/align.c ma_blocks_batch).  aln_cut holds GLOBAL frag6 row
    indices; read_aln_off delimits each read's alignments within it.

    Returns (n_match[i64 nb_total], uids_flat[i64], read_cut[n_reads+1])
    where read r's blocks are read_cut[r]:read_cut[r+1] and each of its
    blocks contributes (read_aln_off[r+1]-read_aln_off[r]) uids to
    uids_flat, in block order.  None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = n_threads_default()
    n_reads = len(read_aln_off) - 1
    max_aln = int(np.max(np.diff(read_aln_off))) if n_reads else 1
    cap_blocks = max(1024, 64 * n_reads + 2 * len(scm_flat))
    while True:
        out_nm = np.empty(cap_blocks, np.int64)
        out_u = np.empty(cap_blocks * max(1, max_aln), np.int64)
        read_cut = np.empty(n_reads + 1, np.int64)
        ret = lib.ma_blocks_batch(
            scm_flat.ctypes.data, scm_off.ctypes.data,
            frag6.ctypes.data, aln_cut.ctypes.data, read_aln_off.ctypes.data,
            n_reads,
            va_flat.ctypes.data, va_off.ctypes.data,
            n_threads,
            out_nm.ctypes.data, out_u.ctypes.data, read_cut.ctypes.data,
            cap_blocks, len(out_u),
        )
        if ret == -2:
            raise MemoryError("ma_blocks_batch: allocation failure")
        if ret >= 0:
            nb = int(ret)
            n_aln_r = np.diff(read_aln_off)
            nb_r = np.diff(read_cut)
            n_uids = int(np.sum(nb_r * n_aln_r))
            return out_nm[:nb], out_u[:n_uids], read_cut
        cap_blocks *= 4


def find_lcs_native(s_ids, u_ids, offset: int):
    """LCS match blocks (native/align.c); returns [(start, len)] or None."""
    lib = _load()
    if lib is None:
        return None
    cap = 2 * (len(s_ids) + len(u_ids)) + 8
    out = np.empty((cap, 2), np.int64)
    ret = lib.find_lcs(
        s_ids.ctypes.data, len(s_ids), u_ids.ctypes.data, len(u_ids),
        offset, out.ctypes.data, cap,
    )
    if ret == -2:
        raise MemoryError("find_lcs: allocation failure")
    assert ret >= 0, "find_lcs capacity exceeded"
    return out[: int(ret)]


def ec_correct_reads(
    idx_p, idx_n, aw, als, adel, seq_flat, seq_off, vtx_len, scm_del,
    kflat, mflat, moff, code_flat, hoff, hoco_l, w: int, max_edist: float,
    n_threads: int | None = None,
    lazy_src=None, lazy_rev=None, lazy_codes=None,
):
    """Batched graph-path error correction (native/ec.c).

    When ``lazy_src``/``lazy_rev`` are given (per-vertex hoco-stream
    offset / orientation, offset -1 => all-N vertex), vertex consensus
    bytes are decoded on demand from ``code_flat`` and
    ``seq_flat``/``seq_off`` are ignored.

    Returns (stats[11], out_kmer, out_mpos, out_cut, out_upd) or None
    when the native library is unavailable / hits an internal limit
    (caller falls back to the Python path)."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = n_threads_default()
    n_reads = len(moff) - 1
    cap_out = max(1024, 2 * len(kflat) + 1024)
    while True:
        stats = np.zeros(11, np.int64)
        out_kmer = np.empty(cap_out, np.uint64)
        out_mpos = np.empty(cap_out, np.uint32)
        out_cut = np.empty(n_reads + 1, np.int64)
        out_upd = np.empty(n_reads, np.uint8)
        ret = lib.ec_correct_reads(
            idx_p.ctypes.data, idx_n.ctypes.data, len(idx_p),
            aw.ctypes.data, als.ctypes.data, adel.ctypes.data,
            seq_flat.ctypes.data, seq_off.ctypes.data, vtx_len.ctypes.data,
            scm_del.ctypes.data,
            lazy_src.ctypes.data if lazy_src is not None else None,
            lazy_rev.ctypes.data if lazy_rev is not None else None,
            lazy_codes.ctypes.data if lazy_codes is not None else None,
            kflat.ctypes.data, mflat.ctypes.data, moff.ctypes.data, n_reads,
            code_flat.ctypes.data, hoff.ctypes.data, hoco_l.ctypes.data,
            w, ctypes.c_double(max_edist), n_threads,
            stats.ctypes.data,
            out_kmer.ctypes.data, out_mpos.ctypes.data,
            out_cut.ctypes.data, out_upd.ctypes.data,
            cap_out,
        )
        if ret == -2:
            return None  # allocation failure / wavefront overflow: fall back
        if ret >= 0:
            return stats, out_kmer[: int(ret)], out_mpos[: int(ret)], out_cut, out_upd
        cap_out *= 4


def pack_rows(codes: np.ndarray, offs: np.ndarray, row0: int, n_rows: int, row_bytes: int):
    lib = _load()
    out = np.zeros((n_rows, row_bytes), np.uint8)
    lib.pack_rows(
        codes.ctypes.data, offs.ctypes.data, row0, n_rows, row_bytes, out.ctypes.data
    )
    return out


def pack_rows_gather(
    codes: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    row_bytes: int,
    out: np.ndarray | None = None,
):
    """2-bit pack an arbitrary subset of reads into padded rows in one
    native call.  ``out`` may have more rows than reads (zero padding);
    the first ``len(starts)`` rows are filled."""
    lib = _load()
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    if out is None:
        out = np.zeros((len(starts), row_bytes), np.uint8)
    lib.pack_rows_gather(
        codes.ctypes.data, starts.ctypes.data, ends.ctypes.data,
        len(starts), row_bytes, out.ctypes.data,
    )
    return out
