"""Two-process jax.distributed smoke test for the sharded syncmer path.

Covers what the single-process virtual mesh cannot: cross-process (DCN
analogue) collectives.  Two CPU processes with 4 local devices each form
one 8-device global mesh; both run the sharded extraction + hash-routed
collection, and each asserts the resulting SyncmerDB matches the
single-device host build."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from genome_sim import random_genome, sample_reads, write_reads

WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]
fa = sys.argv[3]
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2
assert len(jax.devices()) == 8, len(jax.devices())

import numpy as np
import oatk_tpu  # noqa: F401
from oatk_tpu.asm.pipeline import load_reads
from oatk_tpu.dist.sharded_db import load_and_extract_sharded
from oatk_tpu.dist.sharding import make_mesh
from oatk_tpu.index.syncmer_db import collect_syncmer_db

mesh = make_mesh(8)
db2, coll = load_and_extract_sharded([fa], 151, 13, mesh)
scm2 = coll.build(db2)

# independent single-process-style host build for comparison (uses only
# local host compute on replicated inputs)
db1 = load_reads([fa], 151, 13, 0, use_device=False)
scm1 = collect_syncmer_db(db1)

assert scm1.n == scm2.n, (scm1.n, scm2.n)
assert np.array_equal(scm1.h, scm2.h)
assert np.array_equal(scm1.cov, scm2.cov)
for a, b in zip(scm1.m_pos, scm2.m_pos):
    assert np.array_equal(a, b)
for r1, r2 in zip(db1.reads, db2.reads):
    assert np.array_equal(r1.k_mer, r2.k_mer)

# full multi-host assembly: every process runs the complete syncasm over
# the 2-process global mesh.  With jax.distributed active, alignment and
# EC automatically shard reads across the two processes and allgather
# (dist/stages.py) -- the result must byte-match BOTH the local run and
# the parent's true single-process golden GFA.
import os
from oatk_tpu.asm.pipeline import syncasm

golden = sys.argv[4]
out_dir = os.path.dirname(fa)
syncasm([fa], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
        out=os.path.join(out_dir, f"mesh_p{pid}"), shards=8)
syncasm([fa], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
        out=os.path.join(out_dir, f"local_p{pid}"))
a = open(os.path.join(out_dir, f"mesh_p{pid}.utg.final.gfa"), "rb").read()
b = open(os.path.join(out_dir, f"local_p{pid}.utg.final.gfa"), "rb").read()
c = open(golden, "rb").read()
assert a == b and a, "multi-host assembly diverged"
assert a == c, "multi-host assembly differs from single-process golden"
print(f"proc {pid} OK n={scm2.n}", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_collection(tmp_path):
    rng = np.random.default_rng(99)
    g = random_genome(rng, 15000)
    reads = sample_reads(rng, g, coverage=8, read_len=2000, err_rate=0.001)
    fa = tmp_path / "reads.fa"
    write_reads(str(fa), reads)
    # single-process golden for the workers to byte-compare against
    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fa)], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
            out=str(tmp_path / "golden"))
    golden = str(tmp_path / "golden.utg.final.gfa")
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())

    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).parent.parent)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, str(fa), golden],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK" in out
