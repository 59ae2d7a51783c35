"""nhmmscan batch annotation runner (run_hmmannot.c analogue).

Streaming 3-stage pipeline matching the reference's kt_pipeline
semantics (/root/reference/run_hmmannot.c:130-333, kthread.c:176-256):

- stage 0 (reader thread): split FASTA/FASTQ/GFA-S-line input into
  <= max_batch_size temp FASTAs, grouped into units of up to
  max_batch_num batches; each batch's ``nhmmscan --noali --cpu 1
  --tblout`` subprocess (3 retries) is submitted the moment its file
  closes, so scanning overlaps the remaining split work;
- stage 1 (subprocess pool, n_threads wide): the nhmmscan runs;
- stage 2 (caller thread): units drain IN ORDER, tblouts concatenate
  to fo and temp files unlink immediately -- in-flight temp file pairs
  stay bounded by (queue depth + 2) * max_batch_num, the analogue of
  kt_pipeline's bounded in-flight steps.

This replaces the round-2 design that materialized every batch FASTA
before the first scan started.
"""
from __future__ import annotations

import gzip
import os
import queue
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

from ..utils import log_error, log_info


def _iter_seqs(path: str):
    """Yield (name, seq) from FASTA/FASTQ(.gz)/GFA S-lines."""
    with open(path, "rb") as raw:
        magic = raw.read(2)
    op = gzip.open if magic == b"\x1f\x8b" else open
    mode = "rt"
    is_fa = is_fq = is_gfa = False
    name, chunks = None, []
    with op(path, mode) as fp:
        it = iter(fp)
        for line in it:
            line = line.rstrip("\n")
            if not line:
                continue
            if not is_gfa and line[0] == ">":
                is_fa = True
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            elif not is_gfa and not is_fa and line[0] == "@":
                is_fq = True
                nm = line[1:].split()[0]
                seq = next(it).rstrip("\n")
                next(it)
                next(it)
                yield nm, seq
            elif is_fa:
                chunks.append(line)
            else:
                is_gfa = True
                f = line.split("\t")
                if f[0] == "S" and len(f) > 2 and f[2] != "*":
                    yield f[1], f[2]
        if name is not None:
            yield name, "".join(chunks)


def run_cmd_retry(cmd: str, retries: int = 3) -> int:
    for i in range(retries):
        ret = subprocess.run(cmd, shell=True).returncode
        if ret == 0:
            return 0
    return ret


def check_executable(exe: str) -> bool:
    return shutil.which(exe) is not None


def hmm_annotate(
    files: list[str],
    nhmmscan: str,
    nhmmdb: str,
    fo,
    max_batch_size: int = 100000,
    max_batch_num: int = 0,
    n_threads: int = 1,
    tmpdir: str | None = None,
) -> int:
    """Annotate sequences against an HMM database, writing tblout to fo."""
    if max_batch_num <= 0:
        max_batch_num = n_threads * 5
    own_tmp = tmpdir is None
    if own_tmp:
        tmpdir = tempfile.mkdtemp(prefix="tmp_")
    os.makedirs(tmpdir, exist_ok=True)

    abort = threading.Event()

    def scan(fin: str, fout: str) -> None:
        if abort.is_set():
            raise RuntimeError("aborted")
        cmd = f"{nhmmscan} --noali --cpu 1 -o /dev/null --tblout {fout} {nhmmdb} {fin}"
        ret = run_cmd_retry(cmd, 3)
        if ret != 0:
            log_error(f"command failed: {cmd}", func="hmm_annotate")
            raise RuntimeError(cmd)

    try:
        with ThreadPoolExecutor(max_workers=max(1, n_threads)) as pool:
            for path in files:
                # bounded unit queue: with the unit being read and the
                # unit being drained that caps in-flight temp pairs at
                # 4 * max_batch_num (kt_pipeline keeps <= n_steps units
                # in flight the same way)
                units: "queue.Queue" = queue.Queue(maxsize=2)

                def reader() -> None:
                    unit: list[tuple[str, str, object]] = []
                    n_seq = l_seq = cur_size = 0
                    cur_fp = None
                    fin = fout = ""

                    def new_batch():
                        nonlocal cur_fp, cur_size, fin, fout
                        f = tempfile.NamedTemporaryFile(
                            mode="w", suffix=".fa", dir=tmpdir, delete=False
                        )
                        fin, fout = f.name, f.name[:-3] + ".out"
                        cur_fp = f
                        cur_size = 0

                    def close_batch():
                        # submit the scan the moment the file closes:
                        # stage 1 starts while stage 0 keeps splitting
                        nonlocal cur_fp
                        cur_fp.close()
                        cur_fp = None
                        unit.append((fin, fout, pool.submit(scan, fin, fout)))

                    def flush_unit():
                        # per-unit message with per-unit counters, as the
                        # reference prints per pipeline step
                        # (run_hmmannot.c:255)
                        nonlocal unit, n_seq, l_seq
                        log_info(
                            f"{n_seq} sequences ({l_seq} bp) loaded in "
                            f"{len(unit)} batch{'es' if len(unit) > 1 else ''}",
                            func="annot_worker_pipeline",
                        )
                        units.put(unit)
                        unit = []
                        n_seq = l_seq = 0

                    try:
                        new_batch()
                        for name, seq in _iter_seqs(path):
                            if abort.is_set():
                                break
                            if cur_size >= max_batch_size:
                                close_batch()
                                if len(unit) >= max_batch_num:
                                    flush_unit()
                                new_batch()
                            cur_fp.write(f">{name}\n{seq}\n")
                            cur_size += len(seq)
                            n_seq += 1
                            l_seq += len(seq)
                        if cur_fp is not None:
                            if cur_size > 0:
                                close_batch()
                            else:
                                cur_fp.close()
                                os.unlink(fin)
                        if unit:
                            flush_unit()
                    except BaseException as e:  # surface in the consumer
                        units.put(e)
                    finally:
                        units.put(None)

                t = threading.Thread(target=reader, daemon=True)
                t.start()
                try:
                    while True:
                        unit = units.get()
                        if unit is None:
                            break
                        if isinstance(unit, BaseException):
                            raise unit
                        for fin, fout, fut in unit:
                            fut.result()  # re-raises scan failures
                            with open(fout) as f:
                                shutil.copyfileobj(f, fo)
                            os.unlink(fin)
                            os.unlink(fout)
                except BaseException:
                    abort.set()
                    # unblock the reader if it is waiting on a full queue
                    while t.is_alive():
                        try:
                            units.get_nowait()
                        except queue.Empty:
                            pass
                        t.join(timeout=0.05)
                    raise
                t.join()
    finally:
        if own_tmp:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return 0
