"""syncasm pipeline driver (run_syncasm.c:56-322 analogue).

Stage order matches the reference: read+extract -> stats (auto -c) ->
count -> [EC on unfiltered graph] -> filtered graph -> unitig ->
pre-unzip clean (tips only when unzipping) -> unzip rounds ->
demultiplex -> coverage estimation -> final clean -> consensus GFA.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..index.histogram import read_db_stat
from ..index.syncmer_db import collect_syncmer_db
from ..io.fastx import read_fastx
from ..graph.clean import drop_tip, pop_bubble, remove_weak_crosslink
from ..utils import log_error, log_info
from .consensus import scg_consensus
from .reads import ReadDB, _device_hoco_enabled, extract_all_syncmers, load_and_extract
from .scg import (
    Scg,
    make_syncmer_graph,
    process_mergeable_unitigs,
    scg_stat,
    scg_subgraph_stat,
)


def load_reads(files: list[str], k: int, s: int, max_data: int = 0, use_device: bool = True) -> ReadDB:
    """Load reads + extract syncmers through the fused native-parse ->
    device-extraction loader (:func:`load_and_extract`); falls back to
    the Python reader + :func:`extract_all_syncmers` when the native
    library is unavailable or the input mixes FASTA and FASTQ records.
    OATK_TPU_DEVICE_HOCO=1 takes the raw-ASCII upload with on-device
    homopolymer compression instead.

    OATK_TPU_COUNT picks the counting path ('device' | 'host' |
    'auto' [default]).  Device-resident counting does one finalize sort
    on the device and one exact-size async-prefetched fetch; 'auto'
    uses it from ~60 MB of input and the host sort below, where fixed
    per-chunk costs dominate."""
    import os as _os

    if use_device and not _device_hoco_enabled():
        _cnt = _os.environ.get("OATK_TPU_COUNT", "auto").strip().lower()
        if _cnt not in ("device", "host", "auto"):
            import sys as _sys

            print(
                f"[W::syncasm] OATK_TPU_COUNT={_cnt!r} not in "
                "{'auto','device','host'}; using 'auto'",
                file=_sys.stderr,
            )
            _cnt = "auto"
        if _cnt == "auto":
            try:
                total = sum(_os.path.getsize(f) for f in files)
            except OSError:
                total = 1 << 62  # pipes/URLs: size unknown, assume large
            _cnt = "host" if total < (60 << 20) else "device"
        db = load_and_extract(files, k, s, max_data, device_count=_cnt != "host")
        if db is not None:
            return db
    records = read_fastx(files, max_data)
    return extract_all_syncmers(records, k, s, use_device=use_device)


@dataclass
class SyncasmResult:
    read_db: ReadDB
    scm_db: object
    scg: Scg | None
    ra_db: list | None = None
    timings: dict | None = None  # per-stage wall seconds (bench shares)


def syncasm(
    files: list[str],
    k: int = 1001,
    s: int = 31,
    min_k_cov: int = 3,
    min_a_cov_f: float = 0.35,
    bubble_size: int = 100000,
    tip_size: int = 10000,
    weak_cross: float = 0.3,
    do_ec: bool = True,
    do_unzip: int = 3,
    max_data: int = 0,
    out: str = "syncasm.asm",
    use_device: bool = True,
    verbose: int = 0,
    shards: int = 0,
    threads: int = 0,
) -> SyncasmResult:
    import contextlib
    import os as _os

    prof_dir = _os.environ.get("OATK_TPU_PROFILE")
    prof_ctx = contextlib.nullcontext()
    if prof_dir:
        # opt-in structured tracing (SURVEY §5): a TensorBoard-loadable
        # device+host trace of the whole run; kept off the -v stderr
        # path, which stays byte-identical to the reference
        import jax as _jax

        prof_ctx = _jax.profiler.trace(prof_dir)
    # cyclic GC off for the run: the per-vertex/per-read object
    # populations (hundreds of thousands at Gbp scale) make every gen-2
    # collection scan them, costing ~seconds per assembly; nothing in
    # the pipeline relies on cycle collection (arrays + flat objects)
    import gc as _gc

    gc_was_on = _gc.isenabled()
    _gc.disable()
    # CLI -t (reference run_syncasm.c:360,381: one value governs every
    # threaded stage -- parse, align, EC, sorts).  threads=0 keeps the
    # library default (OATK_TPU_THREADS env, else cpu_count).
    from .. import native as _native

    if threads >= 1:
        _native.set_threads(threads)
    try:
        with prof_ctx:
            return _syncasm_impl(
                files, k, s, min_k_cov, min_a_cov_f, bubble_size, tip_size,
                weak_cross, do_ec, do_unzip, max_data, out, use_device, verbose,
                shards,
            )
    finally:
        if threads >= 1:
            _native.set_threads(0)
        if gc_was_on:
            _gc.enable()


def _syncasm_impl(
    files, k, s, min_k_cov, min_a_cov_f, bubble_size, tip_size, weak_cross,
    do_ec, do_unzip, max_data, out, use_device, verbose, shards,
) -> SyncasmResult:
    import os as _os
    import time as _time

    _tm: dict[str, float] = {}
    _tick = [_time.perf_counter()]

    def _t(stage: str) -> None:
        # OATK_TPU_TIMEIT stage accounting ([T::syncasm] on stderr at
        # return); no-op cost when disabled is one perf_counter call
        now = _time.perf_counter()
        _tm[stage] = _tm.get(stage, 0.0) + (now - _tick[0])
        _tick[0] = now

    _timeit = bool(_os.environ.get("OATK_TPU_TIMEIT"))
    collector = None
    if shards >= 1 and not use_device:
        log_info("--cpu disables the device mesh; ignoring --shards", func="syncasm")
        shards = 0
    if shards >= 1:
        # multi-chip path: data-parallel extraction + hash-range-routed
        # occurrence sharding over a device mesh (dist/sharded_db.py);
        # produces a byte-identical SyncmerDB to the host path.
        # shards=1 keeps the global occurrence sort on the device (the
        # host lexsort dominates single-chip runs at large scale).
        from ..dist.sharded_db import load_and_extract_sharded
        from ..dist.sharding import make_mesh

        mesh = make_mesh(shards)
        read_db, collector = load_and_extract_sharded(files, k, s, mesh, max_data)
    else:
        read_db = load_reads(files, k, s, max_data, use_device)
    _t("load")
    log_info(f"collected syncmers from {read_db.n} target sequence(s)", func="syncasm")
    # DB collection runs before the (silent-output-independent) stat
    # pass: the stat's k-mer grouping then counts dense syncmer ids via
    # bincount instead of re-sorting raw 64-bit hashes.  The printed
    # stats are identical either way -- they depend only on the count
    # multiset, which the hash->id rewrite preserves (locked by the
    # -v stderr byte-parity tests).
    if collector is not None:
        try:
            scm_db = collector.build(read_db)
        except RuntimeError as e:
            # capacity overflow on a skewed hash distribution: the host
            # path has everything it needs in read_db, so fall back to
            # the single-process sort rather than aborting the assembly
            log_info(f"sharded merge fell back to host sort: {e}", func="syncasm")
            scm_db = collect_syncmer_db(read_db)
    else:
        scm_db = collect_syncmer_db(read_db)
    _t("collect_db")
    read_db_stat(read_db, sys.stderr, verbose)
    _t("stat")

    if min_k_cov == 0:
        st = read_db.stats
        het, hom = st.get("kmer_peak_het", -1), st.get("kmer_peak_hom", -1)
        min_k_cov = het * 10 if het > 0 else hom * 10
        log_info(f"set minimum kmer coverage as {min_k_cov}", func="syncasm")

    if scm_db is None:
        log_error("no syncmers collected", func="syncasm")
        return SyncasmResult(read_db, None, None)

    if do_ec:
        from .ec import read_error_correction

        _t("_")
        scg0 = make_syncmer_graph(read_db, scm_db, 0, 0.0)
        _t("ec_graph0")
        scg_consensus(read_db, scg0, hoco_seq=True, save_seq=True, fo=None)
        _t("ec_consensus0")
        read_error_correction(
            read_db, scg0, 0.02, min_k_cov, min_k_cov * 10, min_k_cov, min_a_cov_f, verbose
        )
        _t("ec")
        read_db_stat(read_db, sys.stderr, verbose)
        _t("stat2")

    log_info("make syncmer graph", func="syncasm")
    _t("_")
    scg = make_syncmer_graph(read_db, scm_db, min_k_cov, min_a_cov_f)
    _t("make_graph")
    if scg.is_empty():
        log_error("empty syncmer graph", func="syncasm")
        return SyncasmResult(read_db, scm_db, None)
    log_info("syncmer graph stats", func="syncasm")
    scg_stat(scg, sys.stderr)
    if verbose > 1:
        scg_subgraph_stat(scg, sys.stderr)

    log_info("syncmer graph unitigging", func="syncasm")
    _t("_")
    process_mergeable_unitigs(scg)
    _t("unitig")
    log_info("syncmer graph stats after unitigging", func="syncasm")
    scg_stat(scg, sys.stderr)
    _t("_")
    with open(out + ".utg.gfa", "w") as fo:
        scg_consensus(read_db, scg, hoco_seq=False, save_seq=False, fo=fo)
    _t("utg_gfa")
    if verbose > 1:
        scg_subgraph_stat(scg, sys.stderr)

    # basic cleanup (no bubble popping before unzip: protects haplotypes)
    log_info("syncmer graph cleanup", func="syncasm")
    cleaned = 1
    while cleaned:
        cleaned = 0
        if do_unzip <= 0:
            cleaned += pop_bubble(scg.utg, bubble_size, 0, False, True, False, verbose)
            cleaned += remove_weak_crosslink(scg.utg, weak_cross, 10, False, verbose)
        cleaned += drop_tip(scg.utg, 0x7FFFFFFF, tip_size, True, False, verbose)
    process_mergeable_unitigs(scg)

    ra_db: list = []
    if do_unzip > 0:
        from .align import scg_read_alignment
        from .coverage import scg_ra_arc_coverage, scg_ra_utg_coverage, scg_update_utg_cov
        from .unzip import scg_demultiplex, scg_multiplex

        log_info("assembly graph unzipping", func="syncasm")
        max_n_scm = int(np.ceil(30000.0 / k))
        rounds = 0
        updated = 1
        while updated and rounds < do_unzip:
            rounds += 1
            _t("_")
            ra_db = scg_read_alignment(read_db, scg, for_unzip=True, old_ra_db=ra_db)
            _t("unzip_align")
            scg_update_utg_cov(scg)
            updated = scg_multiplex(scg, ra_db, max_n_scm, 10, 0.3)
            _t("multiplex")
            if verbose:
                log_info(
                    f"syncmer graph stats after multiplexing round {rounds}", func="syncasm"
                )
                scg_stat(scg, sys.stderr)

        _t("_")
        ra_db = scg_read_alignment(read_db, scg, for_unzip=True, old_ra_db=ra_db)
        _t("unzip_align")
        scg_ra_arc_coverage(scg, read_db, ra_db, refine=False, verbose=verbose)
        remove_weak_crosslink(scg.utg, weak_cross, 10, False, verbose)

        scg_demultiplex(scg)
        _t("demux")
        ra_db = scg_read_alignment(read_db, scg, for_unzip=False)
        _t("unzip_align2")
        scg_ra_utg_coverage(scg, read_db, ra_db, verbose)
        scg_ra_arc_coverage(scg, read_db, ra_db, refine=True, verbose=verbose)
        _t("unzip_cov")
        scg_consensus(read_db, scg, hoco_seq=False, save_seq=False, fo=None)
        _t("unzip_consensus")

        cleaned = 1
        while cleaned:
            cleaned = 0
            cleaned += pop_bubble(scg.utg, bubble_size, 0, False, True, False, verbose)
            cleaned += remove_weak_crosslink(scg.utg, weak_cross, 10, False, verbose)
            cleaned += drop_tip(scg.utg, 0x7FFFFFFF, tip_size, True, False, verbose)
        process_mergeable_unitigs(scg)

    # final coverage estimation + output
    from .align import scg_read_alignment
    from .coverage import scg_ra_arc_coverage, scg_ra_utg_coverage

    _t("_")
    ra_db = scg_read_alignment(read_db, scg, for_unzip=False)
    _t("final_align")
    scg_ra_utg_coverage(scg, read_db, ra_db, verbose)
    scg_ra_arc_coverage(scg, read_db, ra_db, refine=True, verbose=verbose)
    _t("final_cov")

    log_info("syncmer graph stats after final processing", func="syncasm")
    scg_stat(scg, sys.stderr)
    _t("_")
    with open(out + ".utg.final.gfa", "w") as fo:
        scg_consensus(read_db, scg, hoco_seq=False, save_seq=False, fo=fo)
    _t("final_gfa")
    _tm.pop("_", None)
    if _timeit and _tm:
        parts = " ".join(f"{k_}={v * 1000:.1f}ms" for k_, v in _tm.items())
        print(f"[T::syncasm] {parts}", file=sys.stderr, flush=True)

    return SyncasmResult(read_db, scm_db, scg, ra_db, timings=_tm)
