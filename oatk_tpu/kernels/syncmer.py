"""Vectorized closed-syncmer extraction over padded read batches (HOT LOOP 1).

A data-parallel reformulation of the reference's sequential per-base
scan (reference syncmer.c:243-421).  Instead of a rolling
minimizer buffer, selection is expressed with sliding-window minima
(van Herk two-pass prefix/suffix cummin), which XLA vectorizes across a
whole [B, L] read batch:

  Let M[t] be the hash of the s-mer starting at hoco position t
  (sentinel MAX where out of run / symmetric).  For a k-mer window
  starting at p covering s-mers t in [p, p+q-1], q = w - s + 1:

    open(p)  : M[p] attains the window minimum (oldest-attaining rule)
    close(p) : the last s-mer is a new minimum versus the *previous*
               window  [p-1, p+q-2]  (case 2), or the previous minimum
               was uniquely expiring and the last s-mer wins the
               recomputed window, including the documented tie rule
               (case 3)
    selected(p) = open(p) XOR close(p)   -- the XOR realizes the
               same-position pair removal of the sequential code

  The equivalence with the sequential buffer semantics is validated
  against :mod:`oatk_tpu.kernels.oracle` (itself bit-checked against the
  reference binary's DEBUG_SYNCMER_SEQ dump).

Hash values fit in 2s <= 62 bits, so window minima run in int64; the
Murmur k-mer identity hash runs in uint64.

Every extractor below is one selection (:func:`select_syncmers`) over
hoco codes followed by :func:`_selected_details`; they differ only in
how the codes reach the device.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .hashes import MURMUR_SEED

I64MAX = np.int64(0x7FFFFFFFFFFFFFFF)
_MURMUR_M = np.uint64(0xC6A4A7935BD1E995)

# ASCII -> 2-bit code table (4 = ambiguous)
from .oracle import SEQ_NT4  # noqa: E402


def _hash64_i64(key: jnp.ndarray, mask: np.uint64) -> jnp.ndarray:
    """Thomas Wang 64-bit mix under mask, on int64 lanes (values < 2^62)."""
    k = key.astype(jnp.uint64)
    m = jnp.uint64(mask)
    k = (~k + (k << 21)) & m
    k = k ^ (k >> 24)
    k = (k + (k << 3) + (k << 8)) & m
    k = k ^ (k >> 14)
    k = (k + (k << 2) + (k << 4)) & m
    k = k ^ (k >> 28)
    k = (k + (k << 31)) & m
    return k.astype(jnp.int64)


def _winmin(M: jnp.ndarray, win: int) -> jnp.ndarray:
    """Sliding-window minimum over the last axis (van Herk / two cummins).

    Returns W with W[..., p] = min(M[..., p : p+win]); windows that run
    past the end use I64MAX padding.  win >= 1.
    """
    B, L = M.shape
    if win == 1:
        return M
    nb = -(-L // win)
    pad = nb * win - L
    Mp = jnp.pad(M, ((0, 0), (0, pad + win)), constant_values=I64MAX)
    blocks = Mp[:, : nb * win + win].reshape(B, nb + 1, win)
    pref = lax.cummin(blocks, axis=2)
    suff = lax.cummin(blocks, axis=2, reverse=True)
    pref = pref.reshape(B, -1)
    suff = suff.reshape(B, -1)
    # winmin[p] = min(suffix-in-block(p), prefix-in-block(p+win-1))
    return jnp.minimum(suff[:, :L], pref[:, win - 1 : win - 1 + L])


def _pack_window_bytes(win_codes: jnp.ndarray, w: int) -> jnp.ndarray:
    """[N, w] 2-bit codes -> [N, nblk*8] packed uint8 (base 4j in bits
    7-6 of byte j; zero-padded past ceil(w/4) bytes)."""
    N = win_codes.shape[0]
    n_bytes = (w - 1) // 4 + 1
    nblk = -(-n_bytes // 8)
    # build the packed bytes in u8 and BITCAST to words: the previous
    # i32 formulation materialized a [N, nblk*32] i32 intermediate
    # (54 MB per 3 Mbp chunk); u8 shifts + bitcast_convert_type keep
    # every intermediate at 1 B/lane and the word assembly free
    padded = jnp.pad(win_codes.astype(jnp.uint8), ((0, 0), (0, nblk * 32 - w)))
    quads = padded.reshape(N, nblk * 8, 4)
    return (
        (quads[..., 0] << 6) | (quads[..., 1] << 4) | (quads[..., 2] << 2) | quads[..., 3]
    )


def _bytes_to_u64(bytes_: jnp.ndarray) -> jnp.ndarray:
    """[N, nblk*8] uint8 -> [N, nblk] LE uint64 Murmur blocks."""
    N, nb8 = bytes_.shape
    words = lax.bitcast_convert_type(bytes_.reshape(N, nb8 // 4, 4), jnp.uint32)
    lo = words[:, 0::2].astype(jnp.uint64)
    hi = words[:, 1::2].astype(jnp.uint64)
    return (hi << 32) | lo


def _rc_packed_bytes(bytes_f: jnp.ndarray, w: int) -> jnp.ndarray:
    """Reverse-complement of 2-bit-packed windows, on the PACKED bytes.

    Operating on the 4x-smaller packed representation replaces the
    [N, w] u8 ``(3 - win)[:, ::-1]`` relayout + second quad pack:
    byte-reverse, swap 2-bit fields within each byte, complement
    (c XOR 3 == 3-c, so XOR 0xFF), then funnel-shift the whole stream
    left by the 2*(4*ceil(w/4) - w) pad bits and re-zero the tail."""
    N, nb8 = bytes_f.shape
    n_bytes = (w - 1) // 4 + 1
    b = bytes_f[:, ::-1]
    b = ((b & 0x03) << 6) | ((b & 0x0C) << 2) | ((b & 0x30) >> 2) | (b >> 6)
    b = b ^ jnp.uint8(0xFF)
    # drop the leading pad bases: shift the byte stream left by `sh` bits
    sh = 2 * (4 * n_bytes - w)
    # the reversed stream starts at byte nb8 - n_bytes (bytes past
    # n_bytes were zero pad in the forward stream)
    b = b[:, nb8 - n_bytes :]
    if sh:
        nxt = jnp.pad(b[:, 1:], ((0, 0), (0, 1)))
        b = (b << sh) | (nxt >> (8 - sh))
    # re-zero: only w bases are valid; the last valid byte keeps its top
    # 2*(w%4 or 4) bits, later bytes are zero
    b = jnp.pad(b, ((0, 0), (0, nb8 - n_bytes)))
    col = jnp.arange(nb8, dtype=jnp.int32)
    keep_bits = 2 * (w % 4) if w % 4 else 8
    lastmask = jnp.uint8((0xFF << (8 - keep_bits)) & 0xFF)
    b = jnp.where(col[None, :] < n_bytes - 1, b, b & lastmask)
    b = jnp.where(col[None, :] >= n_bytes, jnp.uint8(0), b)
    return b


def _murmur64_rows(blocks: jnp.ndarray, n_bytes: int) -> jnp.ndarray:
    """Vectorized MurmurHash64A over rows of LE u64 blocks."""
    m = jnp.uint64(_MURMUR_M)
    n_full = n_bytes >> 3
    n_tail = n_bytes & 7
    h0 = jnp.uint64(MURMUR_SEED) ^ (jnp.uint64(n_bytes) * m)
    h = jnp.full(blocks.shape[0], h0, dtype=jnp.uint64)

    def body(i, h):
        k = blocks[:, i] * m
        k = k ^ (k >> 47)
        k = k * m
        h = h ^ k
        return h * m

    if n_full <= 64:
        # unroll: each fori_loop iteration touches only a [N] u64
        # column, so the loop's per-iteration overhead rivals the math;
        # n_full is static (w is static), the unrolled graph is small
        for i in range(n_full):
            h = body(i, h)
    else:
        h = lax.fori_loop(0, n_full, body, h)
    if n_tail:
        h = h ^ blocks[:, n_full]
        h = h * m
    h = h ^ (h >> 47)
    h = h * m
    h = h ^ (h >> 47)
    return h


def _hoco_phase(seq: jnp.ndarray, lens: jnp.ndarray):
    """Shared homopolymer-compression phase: ASCII [B, L] -> hoco code
    arrays (+ bookkeeping).  Returns dict with hoco_c/hoco_l/ho_rl/is_n
    and the effective-N mask (pad counts as N)."""
    B, L = seq.shape
    nt4 = jnp.asarray(SEQ_NT4)
    c = nt4[seq]
    pos_idx = jnp.arange(L, dtype=jnp.int32)
    in_read = pos_idx[None, :] < lens[:, None]
    c = jnp.where(in_read, c, 5)  # 5 = out-of-read sentinel

    prev = jnp.pad(c[:, :-1], ((0, 0), (1, 0)), constant_values=255)
    keep = ((c == 4) | (prev == 4) | (c != prev)) & (c != 5)
    hpos = jnp.cumsum(keep, axis=1, dtype=jnp.int32) - 1
    hoco_l = jnp.where(
        lens > 0, hpos[jnp.arange(B), jnp.maximum(lens - 1, 0)] + 1, 0
    ).astype(jnp.int32)

    scat = jnp.where(keep, hpos, L)
    b_idx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, L))
    hoco_c = jnp.zeros((B, L), jnp.uint8).at[b_idx, scat].set(
        jnp.where(c == 4, 0, c).astype(jnp.uint8), mode="drop"
    )
    is_n = jnp.zeros((B, L), bool).at[b_idx, scat].set(c == 4, mode="drop")
    raw_of = jnp.full((B, L), -1, jnp.int32).at[b_idx, scat].set(
        jnp.broadcast_to(pos_idx[None, :], (B, L)), mode="drop"
    )
    nxt_raw = jnp.concatenate([raw_of[:, 1:], jnp.full((B, 1), -1, jnp.int32)], axis=1)
    h_in = pos_idx[None, :] < hoco_l[:, None]
    # run length MINUS ONE, matching the ReadSyncmers.ho_rl convention
    # (reference sr_t, /root/reference/syncmer.h:56)
    ho_rl = jnp.where(
        h_in,
        jnp.where(nxt_raw >= 0, nxt_raw, lens[:, None]) - raw_of - 1,
        0,
    ).astype(jnp.int32)
    eff_n = is_n | ~h_in
    return dict(hoco_c=hoco_c, hoco_l=hoco_l, ho_rl=ho_rl, is_n=is_n, eff_n=eff_n, h_in=h_in)


def select_syncmers(codes: jnp.ndarray, w: int, s: int) -> jnp.ndarray:
    """Closed-syncmer selection over hoco codes (the module docstring's
    open/close rules), as one elementwise + window-minimum chain.

    codes: [B, L] uint8 -- 0..3 bases, 4 ambiguous, 5 padding past the
    read's end (padding is contiguous at the row's tail).
    Returns int32 [B, L] selection codes for the k-mer window starting
    at each position: 0 none, 1 open, 2 close."""
    B, L = codes.shape
    q = w - s + 1
    mask = np.uint64((1 << (2 * s)) - 1)
    hp = jnp.arange(L, dtype=jnp.int32)
    bad = codes >= 4

    # ---- run length l[h]: consecutive valid hoco positions ending at h ----
    last_n = lax.cummax(jnp.where(bad, hp[None, :], -1), axis=1)
    l_run = hp[None, :] - last_n  # 0 at N / padding

    # ---- rolling canonical s-mer per ending position ----
    code64 = jnp.where(bad, 0, codes).astype(jnp.int64)
    # closed form: fwd[h] = sum_{j=0..s-1} code[h-s+1+j] << 2(s-1-j)
    fwd = jnp.zeros((B, L), jnp.int64)
    rev = jnp.zeros((B, L), jnp.int64)
    for j in range(s):
        shifted = jnp.pad(code64, ((0, 0), (s - 1 - j, 0)))[:, :L]  # code[h-(s-1-j)]
        fwd = fwd | (shifted << (2 * (s - 1 - j)))
        rev = rev | ((3 - shifted) << (2 * j))

    smer_ok = (l_run >= s) & (fwd != rev)
    canon = jnp.minimum(fwd, rev)
    Mh = jnp.where(smer_ok, _hash64_i64(canon, mask), I64MAX)
    # re-index by s-mer start: M[t] = Mh[t+s-1]
    M = jnp.pad(Mh[:, s - 1 :], ((0, 0), (0, s - 1)), constant_values=I64MAX)

    # ---- window minima ----
    Bq1 = _winmin(M, q - 1)  # min over [p, p+q-2]
    Cq2 = _winmin(M, q - 2) if q > 2 else jnp.full_like(M, I64MAX)

    def shift_l(x, k, fill=I64MAX):  # x[p+k]
        if k == 0:
            return x
        if k >= L:
            return jnp.full_like(x, fill)
        return jnp.pad(x[:, k:], ((0, 0), (0, k)), constant_values=fill)

    last = shift_l(M, q - 1)
    Mp_1 = jnp.pad(M[:, :-1], ((0, 0), (1, 0)), constant_values=I64MAX)  # M[p-1]
    D = shift_l(Bq1, 1)  # min over [p+1, p+q-1]
    C1 = shift_l(Cq2, 1)  # min over [p+1, p+q-2]

    # window [p, p+w-1] holds no N / padding
    clean = shift_l(l_run, w - 1, 0) >= w
    # base after the window: a real base, or the read's end (padding);
    # an N there kills the open syncmer
    after_ok = shift_l(codes, w, jnp.uint8(5)) != 4

    open_ = (M != I64MAX) & (M <= D) & clean & after_ok
    case2 = (last <= Mp_1) & (last <= Bq1)
    case3 = (
        ~case2
        & (Mp_1 <= Bq1)
        & (Mp_1 != I64MAX)
        & ((last < Bq1) | ((M == last) & (M <= C1)))
    )
    close_ = (last != I64MAX) & clean & (case2 | case3)
    return jnp.where(
        open_ ^ close_, jnp.where(open_, jnp.int32(1), jnp.int32(2)), jnp.int32(0)
    )


def _compact_sel(sel_code: jnp.ndarray, max_out: int):
    """Compact nonzero selection codes to ascending flat indices.

    Two-stage and gather-free: segmented sorts and static slices only.

      1. per-subrow (512-wide) sort of ``pos<<2|code`` keys -- the code
         rides in the key's low bits so no post-sort gather is needed;
         keep the first MAXPER candidates per subrow (selection density
         is ~1/500, MAXPER>=64 gives ~60x headroom);
      2. per-GROUP (8 subrows) sort of ``global_rank<<32 |
         flat_idx<<2|code`` int64 candidates truncated to 2*MAXPER,
         then one flat int64 sort over the surviving R/8*2*MAXPER; the
         first max_out slots are the answer in globally-ascending
         order (a 3-level funnel sorts far fewer keys than one flat
         R*MAXPER sort).

    If any subrow holds more than MAXPER selections, or any 8-subrow
    group more than 2*MAXPER (pathological density), the reported
    n_sel is inflated past max_out so the loader's existing overflow
    retry re-dispatches with a larger max_out, which doubles MAXPER
    until exact (MAXPER=SW).

    Returns (flat_idx i32[max_out], oc i32[max_out], valid bool,
    n_sel i32 exact, n_sel_report i32 for the capacity slot).
    """
    B, L = sel_code.shape
    n = B * L
    SW = 512 if (L % 512 == 0 and L > 512) else L
    R = B * (L // SW)
    maxper = min(SW, max(32, _ceil_mult(4 * max_out * SW // max(n, 1), 8)))
    sel2 = sel_code.reshape(R, SW)
    pos4 = jnp.arange(SW, dtype=jnp.int32) << 2
    sent = jnp.int32(SW << 2)
    key1 = jnp.where(sel2 != 0, pos4[None, :] | sel2, sent)
    cnt = jnp.sum(sel2 != 0, axis=1, dtype=jnp.int32)
    over64 = None
    if SW == 512 and maxper < SW:
        # hierarchical stage 1: sort each 64-lane block (21 comparator
        # stages vs 45 at 512 wide), keep the first m64 per block, then
        # sort the 8*m64 survivors per subrow (fewer comparator stages
        # than the flat 512-wide sort).  A block
        # holding more than m64 selections would lose candidates, so
        # that (vanishingly rare: expected density is ~0.26/block)
        # escalates exactly like a maxper overflow; at maxper == SW the
        # flat exact path runs instead, so retries always terminate.
        m64 = max(8, -(-maxper // 8))
        k64 = lax.sort(key1.reshape(R * 8, 64), dimension=1)
        if m64 < 64:
            over64 = jnp.any(k64[:, m64] != sent)
            k64 = k64[:, :m64]
            rs = lax.sort(k64.reshape(R, 8 * m64), dimension=1)[:, :maxper]
        else:
            rs = lax.sort(k64.reshape(R, SW), dimension=1)[:, :maxper]
    else:
        rs = lax.sort(key1, dimension=1)[:, :maxper]
    return _compact_funnel(rs, cnt, R, SW, maxper, n, max_out, over64)


def _compact_funnel(
    rs, cnt, R: int, SW: int, maxper: int, n: int, max_out: int, over_extra=None
):
    """Shared funnel: truncated per-subrow candidates -> per-8-subrow
    truncated sort -> flat sort -> first max_out, with the
    overflow-escalating n_rep (see _compact_sel docstring).

    Keys are the global ``flat_pos<<2 | code`` alone (i32 whenever
    n<<2 fits): an earlier version prefixed the global rank in the high
    32 bits, but the rank order among valid candidates IS the flat-
    position order, and pure-i32 comparator stages cost half the i64
    ones."""
    n_sel = jnp.sum(cnt)
    use32 = (n << 2) < 2**31
    kdt = jnp.int32 if use32 else jnp.int64
    KSENT = kdt(2**31 - 1) if use32 else I64MAX
    base4 = (jnp.arange(R, dtype=kdt) * (SW << 2))[:, None]
    cand = base4 + rs.astype(kdt)
    cand = jnp.where(
        jnp.arange(maxper, dtype=jnp.int32)[None, :] < jnp.minimum(cnt, maxper)[:, None],
        cand,
        KSENT,
    )
    G = 8
    over_grp = jnp.bool_(False)
    if R % G == 0 and R // G >= 2 and maxper < SW:
        grp = lax.sort(cand.reshape(R // G, G * maxper), dimension=1)[:, : 2 * maxper]
        gcnt = jnp.sum(cnt.reshape(R // G, G), axis=1)
        over_grp = jnp.any(gcnt > 2 * maxper)
        cand = grp
    flat = lax.sort(cand.reshape(-1))[:max_out]
    if cand.size < max_out:
        flat = jnp.pad(flat, (0, max_out - cand.size), constant_values=KSENT)
    valid = flat != KSENT
    low = jnp.where(valid, flat.astype(jnp.int64), jnp.int64(n << 2))
    flat_idx = (low >> 2).astype(jnp.int32)
    oc = (low & 3).astype(jnp.int32)
    over = jnp.any(cnt > maxper) | over_grp
    if over_extra is not None:
        over = over | over_extra
    # inflate so the retry's max_out' yields maxper' >= 2*maxper
    fake = jnp.int32(min(maxper * n // (2 * SW), 2**30))
    n_rep = jnp.where(over, jnp.maximum(n_sel, fake), n_sel)
    return flat_idx, oc, valid, n_sel, n_rep


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


def _gather_windows(flat_hoco: jnp.ndarray, starts: jnp.ndarray, w: int) -> jnp.ndarray:
    """Gather length-w uint8 windows at dynamic starts: [N_sel, w].

    Instead of a per-row dynamic_slice, whole 128-byte aligned blocks
    are gathered by block index.  The blocks travel as 32 little-endian
    int32 lanes, realigned with 5 word-level bit-decomposed static lane
    shifts (off//4 < 32) plus one in-lane byte funnel (off%4), then
    unpacked back to bytes (fewer passes over fewer lanes than a
    byte-level realign).

    optimization_barrier pins both operands: without it XLA fuses the
    producers INTO the gather and recomputes them per gathered element.

    For any valid window (start + w <= size) the clipped block fetch
    never touches bytes outside [start, start+w): the realigned slice
    [off, off+w) stays within the first ceil((127+w)/128) blocks.
    """
    n = flat_hoco.size
    if n % 128:
        flat_hoco = jnp.pad(flat_hoco, (0, 128 - n % 128))
    words = lax.bitcast_convert_type(flat_hoco.reshape(-1, 4), jnp.int32)
    blocks, starts = lax.optimization_barrier((words.reshape(-1, 32), starts))
    nblk = (w + 127) // 128 + 1
    b0 = starts // 128
    bidx = b0[:, None] + jnp.arange(nblk, dtype=jnp.int32)[None, :]
    rows = blocks[jnp.clip(bidx, 0, blocks.shape[0] - 1)].reshape(
        starts.shape[0], nblk * 32
    )
    offw = ((starts % 128) // 4).astype(jnp.int32)
    for k in (16, 8, 4, 2, 1):
        shifted = jnp.pad(rows[:, k:], ((0, 0), (0, k)))
        rows = jnp.where((offw & k != 0)[:, None], shifted, rows)
    ob = ((starts % 4) * 8).astype(jnp.int32)
    nxt = jnp.pad(rows[:, 1:], ((0, 0), (0, 1)))
    lo = lax.shift_right_logical(rows, ob[:, None])
    hi = jnp.where((ob > 0)[:, None], lax.shift_left(nxt, (32 - ob)[:, None]), 0)
    rows = lo | hi
    nw = (w + 3) // 4
    bsh = jnp.arange(4, dtype=jnp.int32) * 8
    by = (rows[:, :nw, None] >> bsh[None, None, :]) & 0xFF
    return by.reshape(starts.shape[0], nw * 4)[:, :w].astype(jnp.uint8)


def _selected_details(hoco_c, hoco_l, sel_code, w: int, s: int, max_out: int):
    """Per-selected strand/smer payload/Murmur hash from selection codes.

    sel_code: [B, L] int32 (0 none, 1 open, 2 close)."""
    B, L = hoco_c.shape
    q = w - s + 1
    mask = np.uint64((1 << (2 * s)) - 1)

    flat_idx, oc, valid, n_sel, n_rep = _compact_sel(sel_code, max_out)
    sel_b = (flat_idx // L).astype(jnp.int32)
    sel_p = (flat_idx % L).astype(jnp.int32)
    safe_b = jnp.where(valid, sel_b, 0)
    safe_p = jnp.where(valid, sel_p, 0)

    flat_hoco = hoco_c.reshape(-1)
    # ONE aligned-block gather serves both hashes: the boundary s-mer
    # (start p for open, p+q-1 for close) is a static slice of the
    # k-mer window [p, p+w)
    starts = (safe_b * L + safe_p).astype(jnp.int32)
    win = _gather_windows(flat_hoco, starts, w)
    sm_win = jnp.where(
        (oc == 1)[:, None], win[:, :s], win[:, q - 1 : q - 1 + s]
    ).astype(jnp.uint64)
    sh = jnp.arange(s, dtype=jnp.uint64)
    fwd = jnp.sum(sm_win << (2 * (s - 1 - sh))[None, :], axis=1) & jnp.uint64(mask)
    rev = jnp.sum((jnp.uint64(3) - sm_win) << (2 * sh)[None, :], axis=1) & jnp.uint64(mask)
    z = (fwd > rev).astype(jnp.int32)
    canon = jnp.minimum(fwd, rev)
    payload = (canon << 1) | z.astype(jnp.uint64)
    payload = jnp.where(oc == 2, payload ^ jnp.uint64(1), payload)

    # Murmur identity over the oriented k-mer window: pack the forward
    # window once, derive the reverse-complement on the packed bytes
    # (4x fewer lanes than reversing the u8 window), select per row
    bytes_f = _pack_window_bytes(win, w)
    bytes_r = _rc_packed_bytes(bytes_f, w)
    blocks = _bytes_to_u64(jnp.where((z == 0)[:, None], bytes_f, bytes_r))
    khash = _murmur64_rows(blocks, (w - 1) // 4 + 1)

    per_read = jnp.sum(sel_code != 0, axis=1, dtype=jnp.int32)
    # single-transfer view: (flat_idx<<1|z, smer, khash, n_sel) as ONE
    # int64 array, so a chunk's result is one device->host copy
    row0 = jnp.where(valid, (flat_idx.astype(jnp.int64) << 1) | z.astype(jnp.int64), 0)
    # capacity slot carries n_rep: inflated past max_out when the
    # compaction candidate buffer overflowed, so the loader's existing
    # retry re-dispatches with a larger max_out (which widens MAXPER)
    row0 = jnp.concatenate([row0, n_rep.astype(jnp.int64)[None]])
    row1 = jnp.concatenate([payload.astype(jnp.int64), jnp.zeros(1, jnp.int64)])
    kh64 = lax.bitcast_convert_type(khash.astype(jnp.uint64), jnp.int64)
    row2 = jnp.concatenate([kh64, jnp.zeros(1, jnp.int64)])
    packed_out = jnp.stack([row0, row1, row2])
    return dict(
        n_sel=n_sel,
        sel_b=sel_b,
        sel_p=sel_p,
        sel_z=jnp.where(valid, z, 0),
        sel_smer=payload.astype(jnp.int64),
        sel_khash=khash,
        valid=valid,
        per_read=per_read,
        packed=packed_out,
    )


@partial(jax.jit, static_argnames=("w", "s", "max_out", "return_hoco"))
def extract_syncmers_batch(
    seq: jnp.ndarray,
    lens: jnp.ndarray,
    w: int,
    s: int,
    max_out: int,
    return_hoco: bool = False,
):
    """Extract closed syncmers from a padded raw-ASCII read batch.

    seq: [B, L] uint8 ASCII; positions >= lens[b] are padding.  The
    homopolymer compression runs on the device (:func:`_hoco_phase`);
    return_hoco=True also returns the hoco arrays (hoco_c, hoco_l,
    ho_rl, is_n), so the host can skip its own hoco pass
    (OATK_TPU_DEVICE_HOCO route) at the cost of fetching them.

    Flat selected-syncmer arrays have size max_out (entries beyond
    n_sel are invalid; flat order = (read, position) ascending, which is
    the reference's emission order)."""
    h = _hoco_phase(seq, lens)
    codes = jnp.where(
        h["eff_n"], jnp.where(h["h_in"], 4, 5), h["hoco_c"]
    ).astype(jnp.uint8)
    sel = select_syncmers(codes, w, s)
    out = _selected_details(h["hoco_c"], h["hoco_l"], sel, w, s, max_out)
    if return_hoco:
        out.update(
            hoco_c=h["hoco_c"], hoco_l=h["hoco_l"], ho_rl=h["ho_rl"], is_n=h["is_n"]
        )
    return out


def _unpack_blob(blob: jnp.ndarray, B: int, Lp: int, n_cap: int):
    """Unpack one loader upload blob (layout: :func:`extract_hoco_fused`).
    Returns ``(codes, sel_codes)``: [B, Lp] uint8 codes with 5 past each
    read's end (the window source), and the same codes with 4 at the N
    positions (the selection's input)."""
    np_ = B * Lp // 4
    packed = blob[:np_].reshape(B, Lp // 4)
    hoco_l = lax.bitcast_convert_type(
        blob[np_ : np_ + 4 * B].reshape(B, 4), jnp.int32
    ).reshape(B)
    n_pos = lax.bitcast_convert_type(
        blob[np_ + 4 * B : np_ + 4 * B + 4 * n_cap].reshape(n_cap, 4), jnp.int32
    ).reshape(n_cap)
    shifts = jnp.array([6, 4, 2, 0], jnp.int32)
    codes = (
        ((packed[:, :, None].astype(jnp.int32) >> shifts[None, None, :]) & 3)
        .reshape(B, Lp)
        .astype(jnp.uint8)
    )
    pos = jnp.arange(Lp, dtype=jnp.int32)
    codes = jnp.where(pos[None, :] < hoco_l[:, None], codes, jnp.uint8(5))
    # N positions are marked ONLY on the selection's input, never on
    # hoco_c: the window gather reads exclusively k-mer windows the
    # selection verified N-free, so the mask is invisible to it, and
    # keeping hoco_c's producer mask-free keeps the mask out of the
    # gather's producer fusion (invalid rows' garbage windows are
    # masked by `valid` downstream either way).
    sel_codes = codes
    if n_cap:  # skip for N-free chunks
        # sparse N mask as a one-hot contraction instead of a scatter:
        # split each flat index into (block, lane) one-hots and contract
        # over the index axis -- mask[b, l] = sum_k row_k[b] * col_k[l].
        # 0/1 bf16 operands with f32 accumulation are exact (counts are
        # at most n_cap); the loader's B*Lp pad sentinel falls in block
        # NB (out of iota range) and drops out.
        NB = -(-B * Lp // 512)
        blk = (n_pos // 512).astype(jnp.int32)
        lane = (n_pos % 512).astype(jnp.int32)
        row1h = (blk[:, None] == jnp.arange(NB, dtype=jnp.int32)[None, :]).astype(
            jnp.bfloat16
        )
        col1h = (lane[:, None] == jnp.arange(512, dtype=jnp.int32)[None, :]).astype(
            jnp.bfloat16
        )
        cnt = jax.lax.dot_general(
            row1h,
            col1h,
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        nmask = (cnt > 0.5).reshape(-1)[: B * Lp].reshape(B, Lp)
        sel_codes = jnp.where(nmask, jnp.uint8(4), codes)
    return codes, sel_codes


@partial(jax.jit, static_argnames=("B", "Lp", "n_cap", "w", "s", "max_out"))
def extract_hoco_fused(
    blob: jnp.ndarray,  # [B*Lp//4 + 4*B + 4*n_cap] uint8: packed | hl(i32) | n_pos(i32)
    B: int,
    Lp: int,
    n_cap: int,
    w: int,
    s: int,
    max_out: int,
):
    """The main-path extractor, from one uint8 upload blob per chunk:
    2-bit packed hoco codes (4 bases/byte, first base in the high bits;
    0.25 B/base), per-read hoco lengths (i32) and sparse flat N positions
    (i32, b*Lp + p; padded with the B*Lp sentinel), unpacked on the
    device with bitcasts."""
    codes, sel_codes = _unpack_blob(blob, B, Lp, n_cap)
    sel = select_syncmers(sel_codes, w, s)
    hoco_c = jnp.where(codes < 4, codes, jnp.uint8(0))
    return _selected_details(hoco_c, None, sel, w, s, max_out)



@partial(jax.jit, static_argnames=("w", "s", "max_out"))
def extract_hoco_batch(codes_u8: jnp.ndarray, w: int, s: int, max_out: int):
    """Extraction from pre-compressed 1-byte hoco codes (the sharded
    path's inner extractor).

    codes_u8: [B, L] uint8 with values 0..3 = bases, 4 = ambiguous,
    5 = padding/after-read-end.
    """
    sel = select_syncmers(codes_u8, w, s)
    hoco_c = jnp.where(codes_u8 < 4, codes_u8, 0).astype(jnp.uint8)
    return _selected_details(hoco_c, None, sel, w, s, max_out)
