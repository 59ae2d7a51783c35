"""Randomized syncasm+pathfinder parity stress sweep (not part of the
fast suite; run manually: python tests/stress_parity.py [n_iters])."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import subprocess
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))

from genome_sim import random_genome, sample_reads, write_reads  # noqa: E402
from test_syncasm_parity import _assert_gfa_equal  # noqa: E402

REFBIN = Path("/root/refbin")


def one_case(seed: int, tmp: Path) -> str:
    rng = np.random.default_rng(seed)
    ks = [(91, 13), (151, 13), (251, 17), (501, 21)][int(rng.integers(4))]
    k, s = ks
    n_genomes = int(rng.integers(1, 3))
    genome_parts = []
    for _ in range(n_genomes):
        glen = int(rng.integers(6000, 25000))
        g = random_genome(rng, glen)
        if rng.random() < 0.5:  # add a repeat
            rep = random_genome(rng, int(rng.integers(1500, 4000)))
            g = g + rep + random_genome(rng, int(rng.integers(3000, 8000))) + rep
        genome_parts.append(g)
    reads = []
    for g in genome_parts:
        cov = float(rng.integers(8, 25))
        rl = int(rng.integers(1200, 4000))
        err = float(rng.choice([0.0, 0.0, 0.001, 0.003]))
        hp = float(rng.choice([0.0, 0.85]))
        reads += sample_reads(rng, g, cov, rl, err_rate=err, hp_frac=hp)
    rng.shuffle(reads)
    # randomized container format: FASTA / FASTQ / gzip / multiline
    fmt = ["fa", "fa", "fq", "fa.gz", "fq.gz", "fa_wrap"][int(rng.integers(6))]
    if fmt.startswith("fq"):
        body = "".join(
            f"@read{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(reads)
        )
        fa = tmp / "reads.fq"
    elif fmt == "fa_wrap":
        body = "".join(
            f">read{i}\n"
            + "\n".join(r[x : x + 80] for x in range(0, len(r), 80))
            + "\n"
            for i, r in enumerate(reads)
        )
        fa = tmp / "reads.fa"
    else:
        body = "".join(f">read{i}\n{r}\n" for i, r in enumerate(reads))
        fa = tmp / "reads.fa"
    if fmt.endswith(".gz"):
        import gzip as _gz

        fa = tmp / (fa.name + ".gz")
        with _gz.open(fa, "wt") as f:
            f.write(body)
    else:
        fa.write_text(body)

    do_ec = bool(rng.random() < 0.5)
    unzip = int(rng.choice([0, 3]))
    c = int(rng.choice([2, 3, 4]))
    shards = int(rng.choice([0, 0, 5, 8]))

    args = [str(REFBIN / "syncasm"), "-k", str(k), "-s", str(s), "-c", str(c),
            "-o", str(tmp / "ref")]
    if not do_ec:
        args.append("--no-read-ec")
    args += ["--unzip-round", str(unzip), str(fa)]
    subprocess.run(args, check=True, capture_output=True)

    from oatk_tpu.asm.pipeline import syncasm

    syncasm([str(fa)], k=k, s=s, min_k_cov=c, do_ec=do_ec, do_unzip=unzip,
            out=str(tmp / "mine"), shards=shards)
    _assert_gfa_equal(tmp / "ref.utg.gfa", tmp / "mine.utg.gfa")
    _assert_gfa_equal(tmp / "ref.utg.final.gfa", tmp / "mine.utg.final.gfa")
    return (f"k={k} s={s} c={c} ec={int(do_ec)} unzip={unzip} "
            f"shards={shards} reads={len(reads)} fmt={fmt}")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
    fails = 0
    for i in range(n):
        seed = seed0 + i
        with tempfile.TemporaryDirectory() as td:
            try:
                desc = one_case(seed, Path(td))
                print(f"[{i+1}/{n}] seed={seed} OK  ({desc})", flush=True)
            except AssertionError as e:
                fails += 1
                print(f"[{i+1}/{n}] seed={seed} FAIL\n{e}", flush=True)
            except subprocess.CalledProcessError as e:
                print(f"[{i+1}/{n}] seed={seed} REF-ERROR (skipped)", flush=True)
    print(f"done: {fails} failures / {n}")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
