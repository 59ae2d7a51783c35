"""syncasm CLI (run_syncasm.c main analogue)."""
from __future__ import annotations

import argparse
import sys

from ..asm.pipeline import syncasm
from ..utils.log import print_exit_stats
from ._common import parse_data_size


ENV_EPILOG = """\
environment variables:
  OATK_TPU_THREADS       default native pool width when -t is not given
  OATK_TPU_COUNT         counting path: auto|device|host [auto]; 'auto'
                         counts on the device above ~60 MB of input and
                         with the host sort below
  OATK_TPU_DEVICE_HOCO=1 upload raw reads and homopolymer-compress them
                         on the device instead of on the host
  OATK_TPU_TIMEIT        print [T::] per-stage wall timings on stderr
  OATK_TPU_PROFILE=DIR   write a JAX device+host trace (TensorBoard)
  JAX_COMPILATION_CACHE_DIR  XLA compile cache dir [<checkout>/.jax_cache]
  OATK_TPU_WF_BACKEND    wavefront DP backend: auto|numpy
  OATK_TPU_DEVICE_CONSENSUS  opt-in device run-length consensus
                         (bit-exact by construction)
  OATK_TPU_DEVICE_EM     EXPERIMENTAL: device coverage-EM loop; float
                         reduction order is NOT guaranteed to reproduce
                         the reference byte-for-byte -- outputs may
                         differ in the last bits on some inputs
"""


def build_parser():
    p = argparse.ArgumentParser(
        prog="syncasm", description="HiFi read assembler (sparse syncmer dBG)",
        epilog=ENV_EPILOG, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("files", nargs="+", help="target.fa[stq][.gz] [...]")
    p.add_argument("-k", type=int, default=1001, help="kmer size [1001]")
    p.add_argument("-s", type=int, default=31, help="smer size (<=31) [31]")
    p.add_argument("-c", type=int, default=3, help="minimum kmer coverage [3]")
    p.add_argument("-a", type=float, default=0.35, help="minimum arc coverage [0.35]")
    p.add_argument("-D", type=parse_data_size, default=0, help="max data; K/M/G suffix")
    p.add_argument(
        "-t", "--threads", type=int, default=1,
        help="number of threads for every native stage (parse, align, "
        "EC, sorts) [1]",
    )
    p.add_argument("-o", default="syncasm.asm", help="prefix of output files")
    p.add_argument("--max-bubble", type=int, default=100000)
    p.add_argument("--max-tip", type=int, default=10000)
    p.add_argument("--weak-cross", type=float, default=0.3)
    p.add_argument("--unzip-round", type=int, default=3)
    p.add_argument("--no-read-ec", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run extraction on host CPU oracle")
    p.add_argument(
        "--shards", type=int, default=0,
        help="shard extraction+counting over this many mesh devices [off]",
    )
    p.add_argument(
        "-v", "--verbose", type=int, default=0,
        help="verbosity; 3 also logs the JAX backend and device [0]",
    )
    p.add_argument("--version", action="version", version="1.0")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.verbose >= 3 and not args.cpu:
        import jax

        from ..utils import log_info

        devs = jax.devices()
        log_info(
            f"JAX backend {jax.default_backend()}, "
            f"{len(devs)} x {devs[0].device_kind}",
            func="main",
        )
    res = syncasm(
        args.files,
        k=args.k,
        s=args.s,
        min_k_cov=args.c,
        min_a_cov_f=args.a,
        bubble_size=args.max_bubble,
        tip_size=args.max_tip,
        weak_cross=args.weak_cross,
        do_ec=not args.no_read_ec,
        do_unzip=args.unzip_round,
        max_data=args.D,
        out=args.o,
        use_device=not args.cpu,
        verbose=args.verbose,
        shards=args.shards,
        threads=args.threads,
    )
    if res.scg is None:
        sys.stderr.write("[E::main] failed to construct assembly\n")
        return 1
    print_exit_stats("main")
    return 0


def _console() -> int:
    """console_scripts entry point."""
    import sys as _sys

    return int(main(_sys.argv[1:]) or 0)


if __name__ == "__main__":
    sys.exit(main())
