"""-v/-v2 stderr diagnostics byte-parity vs the reference syncasm binary.

Regression-locks the intricate bug-compat diagnostics verified manually in
round 1: the khashl count-table replica (_KhCtab in index/histogram.py,
reproducing syncmer.c:608-1028 incl. the stale-singleton artifact), the
ha_analyze_count/hist_plot histograms, the EC summary table with the
reference's swapped seq/path labels (syncerr.c:902-927), and the driver
stage messages.  Timing/CMD/RSS lines are inherently run-specific and are
normalized out before diffing; everything else must match byte-for-byte.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

REFBIN = Path("/root/refbin")

# lines whose values are inherently run-specific (wall/CPU/RSS, command
# line echo, per-stage timing); misc.c:129-154, run_syncasm.c:442-449
_DROP = re.compile(
    r"(Real time:|CPU:|Peak RSS:|CMD:|Version:|real time|CPU time)"
)


def _normalize(stderr_text: str) -> list[str]:
    out = []
    for line in stderr_text.splitlines():
        if _DROP.search(line):
            continue
        out.append(line)
    return out


def _reads(tmp_path, seed, with_repeat=True, err=0.002):
    rng = np.random.default_rng(seed)
    if with_repeat:
        a = random_genome(rng, 7000)
        r = random_genome(rng, 2200)
        b = random_genome(rng, 6000)
        genome = a + r + b + r
    else:
        genome = random_genome(rng, 16000)
    reads = sample_reads(rng, genome, coverage=14, read_len=2200, err_rate=err)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    return fa


def _run_ref(tmp_path, fa, v, ec, unzip):
    args = [str(REFBIN / "syncasm"), "-k", "251", "-s", "17", "-c", "3",
            "-v", str(v), "-o", str(tmp_path / "ref")]
    if not ec:
        args.append("--no-read-ec")
    args += ["--unzip-round", str(unzip), str(fa)]
    cp = subprocess.run(args, check=True, capture_output=True, text=True)
    return cp.stderr


def _run_mine(tmp_path, fa, v, ec, unzip):
    args = [sys.executable, "-m", "oatk_tpu.cli.syncasm", "-k", "251", "-s", "17",
            "-c", "3", "-v", str(v), "-o", str(tmp_path / "mine")]
    if not ec:
        args.append("--no-read-ec")
    args += ["--unzip-round", str(unzip), str(fa)]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(Path(__file__).parent.parent))
    cp = subprocess.run(args, check=True, capture_output=True, text=True, env=env)
    return cp.stderr


@pytest.mark.parametrize(
    "seed,v,ec,unzip,with_repeat",
    [(31, 1, True, 3, True), (32, 2, True, 3, True), (33, 2, False, 0, False)],
    ids=["v1-ec-unzip", "v2-ec-unzip", "v2-plain"],
)
def test_stderr_parity(tmp_path, seed, v, ec, unzip, with_repeat):
    fa = _reads(tmp_path, seed, with_repeat=with_repeat)
    ref = _normalize(_run_ref(tmp_path, fa, v, ec, unzip))
    mine = _normalize(_run_mine(tmp_path, fa, v, ec, unzip))
    assert len(ref) > 20, "reference produced suspiciously little stderr"
    for i, (r, m) in enumerate(zip(ref, mine)):
        assert r == m, (
            f"stderr line {i} differs:\nref : {r!r}\nmine: {m!r}\n"
            f"context ref : {ref[max(0, i - 2):i + 3]}\n"
            f"context mine: {mine[max(0, i - 2):i + 3]}"
        )
    assert len(ref) == len(mine), (
        f"stderr line count differs: ref={len(ref)} mine={len(mine)}\n"
        f"ref tail : {ref[-5:]}\nmine tail: {mine[-5:]}"
    )
