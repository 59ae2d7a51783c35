"""Scaling measurement for the sharded downstream read-parallel stages.

The reference parallelizes read->graph alignment and error correction
with host threads on one machine (P1 /root/reference/alignment.c:636-676,
P3 /root/reference/syncerr.c:882).  oatk_tpu additionally shards both
stages ACROSS processes/hosts (dist/stages.py): reads partition into
contiguous blocks, each process runs its block, results allgather in
read order.  This harness demonstrates that dimension scales: it runs
the full syncasm pipeline under jax.distributed with N CPU processes,
pinning each process to ONE native thread (OATK_TPU_THREADS=1) so the
process axis is the only parallelism, and reports the align/EC stage
walls (max over ranks = the multi-host critical path) plus GFA byte
parity against a golden.

The experiment is controlled: every config uses the SAME 4-device
global mesh for the sharded extraction+counting (nproc processes x
4/nproc local virtual CPU devices), so the load stage costs the same
everywhere and only the process axis of align/EC varies.

Usage:
  python tools/bench_stage_scaling.py --fa /tmp/oatk_300.fa \
      --golden /tmp/oatk_300_ref.utg.final.gfa --procs 1 2 4

Prints one JSON line per process count.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

MESH = 4  # global device count, constant across configs

WORKER = r"""
import os, sys, time
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
fa = sys.argv[4]; out = sys.argv[5]
k = int(sys.argv[6]); s = int(sys.argv[7]); c = int(sys.argv[8])
mesh_n = int(sys.argv[9])
local = max(1, mesh_n // nproc)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={local}"
)
import jax
jax.config.update("jax_platforms", "cpu")

if nproc > 1:
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc
assert len(jax.devices()) == mesh_n, (len(jax.devices()), mesh_n)

from oatk_tpu.asm.pipeline import syncasm

t0 = time.perf_counter()
res = syncasm([fa], k=k, s=s, min_k_cov=c, do_ec=True, do_unzip=3,
              out=out, shards=mesh_n)
wall = time.perf_counter() - t0
tm = res.timings or {}
align = sum(v for kk, v in tm.items() if "align" in kk)
print(f"[SCALE] pid={pid} wall={wall:.3f} align={align:.3f} "
      f"ec={tm.get('ec', 0.0):.3f} load={tm.get('load', 0.0):.3f} "
      f"collect={tm.get('collect_db', 0.0):.3f}", flush=True)
"""


def free_port() -> str:
    with socket.socket() as so:
        so.bind(("localhost", 0))
        return str(so.getsockname()[1])


def run_config(nproc: int, fa: str, golden: str, wd: Path, k: int, s: int, c: int) -> dict:
    worker = wd / "scale_worker.py"
    worker.write_text(WORKER)
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).parent.parent)
    env["OATK_TPU_THREADS"] = "1"
    env["OATK_TPU_TIMEIT"] = "1"
    procs = []
    for pid in range(nproc):
        out = str(wd / f"n{nproc}_p{pid}")
        procs.append(
            subprocess.Popen(
                [sys.executable, str(worker), str(pid), str(nproc), port, fa, out,
                 str(k), str(s), str(c), str(MESH)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            )
        )
    outs = [p.communicate(timeout=7200)[0] for p in procs]
    stats = []
    for pid, (p, txt) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(txt[-4000:])
            raise SystemExit(f"proc {pid}/{nproc} failed rc={p.returncode}")
        m = re.search(
            r"\[SCALE\] pid=\d+ wall=([\d.]+) align=([\d.]+) ec=([\d.]+) "
            r"load=([\d.]+) collect=([\d.]+)", txt)
        assert m, txt[-2000:]
        ec_gather = sum(float(x) for x in re.findall(r"ec_gather=([\d.]+)ms", txt)) / 1e3
        aln_gather = sum(float(x) for x in re.findall(r"aln_gather=([\d.]+)ms", txt)) / 1e3
        stats.append(tuple(float(x) for x in m.groups()) + (ec_gather, aln_gather))
    gold = open(golden, "rb").read()
    for pid in range(nproc):
        got = open(wd / f"n{nproc}_p{pid}.utg.final.gfa", "rb").read()
        assert got == gold and got, f"GFA mismatch (nproc={nproc}, pid={pid})"
    # multi-host critical path = max over ranks per stage
    rec = {
        "n_procs": nproc,
        "align_s": round(max(st[1] for st in stats), 3),
        "ec_s": round(max(st[2] for st in stats), 3),
        "wall_s": round(max(st[0] for st in stats), 3),
        "load_s": round(max(st[3] for st in stats), 3),
        "collect_s": round(max(st[4] for st in stats), 3),
        "ec_gather_s": round(max(st[5] for st in stats), 3),
        "aln_gather_s": round(max(st[6] for st in stats), 3),
        "gfa_parity": "ok",
    }
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fa", required=True)
    ap.add_argument("--golden", required=True)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("-k", type=int, default=1001)
    ap.add_argument("-s", type=int, default=31)
    ap.add_argument("-c", type=int, default=30)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()

    wd = Path(args.workdir or tempfile.mkdtemp(prefix="oatk_scale_"))
    wd.mkdir(parents=True, exist_ok=True)
    recs = [run_config(n, args.fa, args.golden, wd, args.k, args.s, args.c)
            for n in args.procs]
    base = next((r for r in recs if r["n_procs"] == 1), recs[0])
    for r in recs:
        r["align_speedup"] = round(base["align_s"] / r["align_s"], 2) if r["align_s"] else None
        r["ec_speedup"] = round(base["ec_s"] / r["ec_s"], 2) if r["ec_s"] else None
    print(json.dumps({"summary": recs}, indent=None), flush=True)


if __name__ == "__main__":
    main()
