#!/usr/bin/env python
"""Time the closed-syncmer selection against the whole main-path
extraction and the syncasm wall, on the GPU.

1. Generates the plant-like sample of tests/validate_large.py (--mbp).
2. Cuts the loader's real chunks from it (``asm.reads.loader_chunks``)
   and, per distinct chunk shape, runs REPS calls under jax.profiler of
   ``select_syncmers`` alone (over codes unpacked on the device by the
   loader's own ``_unpack_blob``) and of the whole ``extract_hoco_fused``
   (unpack, N mask, selection, compaction, window gather, hashes).  The
   device time per call is the trace's device busy time over REPS; the
   host-timed dispatch+sync time per call is printed beside it.  Scaled
   by the number of chunks of each shape, that gives the selection's
   device seconds per run.
3. Runs syncasm (k=1001, s=31, c=30, EC on, 3 unzip rounds) cold, then
   warm, and prints the selection's share of the warm wall.
4. Runs syncasm once more under jax.profiler and prints the device
   busy share and the top device kernels.

Usage: python tools/time_selection.py [--mbp 110]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
K, S = 1001, 31
REPS = 20


def _traced(fn, trace_dir: str) -> tuple[float, float]:
    """(device s, host-timed s) per fn() call, fn ending in
    block_until_ready: the trace's device busy time over REPS calls, and
    the perf_counter wall of the same calls (dispatch + sync included)."""
    import jax

    fn()  # compile and warm outside the trace
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host = time.perf_counter() - t0
    return reduce_trace(trace_dir)["device_busy_s"] / REPS, host / REPS


def time_chunks(chunks, trace_root: str):
    import jax
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer import _unpack_blob, extract_hoco_fused, select_syncmers

    unpack = jax.jit(_unpack_blob, static_argnames=("B", "Lp", "n_cap"))
    select = jax.jit(select_syncmers, static_argnames=("w", "s"))
    shapes: dict = {}
    for B, Lp, max_out, n_cap, blob in chunks:
        shapes.setdefault((B, Lp, max_out, n_cap), [0, blob])[0] += 1
    rows = []
    for (B, Lp, max_out, n_cap), (count, blob) in sorted(shapes.items()):
        dblob = jnp.asarray(blob)
        _codes, sel_codes = unpack(dblob, B=B, Lp=Lp, n_cap=n_cap)
        tag = f"{B}x{Lp}_n{n_cap}"
        t_sel, h_sel = _traced(
            lambda: select(sel_codes, w=K, s=S).block_until_ready(),
            os.path.join(trace_root, f"select_{tag}"),
        )
        t_all, h_all = _traced(
            lambda: extract_hoco_fused(dblob, B, Lp, n_cap, K, S, max_out)[
                "packed"
            ].block_until_ready(),
            os.path.join(trace_root, f"extract_{tag}"),
        )
        rows.append(dict(B=B, Lp=Lp, n_cap=n_cap, chunks=count,
                         select_device_ms=t_sel * 1e3, extract_device_ms=t_all * 1e3,
                         select_host_ms=h_sel * 1e3, extract_host_ms=h_all * 1e3))
        print(f"shape B={B} Lp={Lp} n_cap={n_cap} x{count}: device (trace) select "
              f"{t_sel * 1e3:.3f} ms, extract_hoco_fused {t_all * 1e3:.3f} ms "
              f"({B * Lp / t_all / 1e9:.2f} G hoco positions/s); host-timed "
              f"dispatch+sync {h_sel * 1e3:.3f} / {h_all * 1e3:.3f} ms", flush=True)
    return rows


def reduce_trace(trace_dir: str, top: int = 25) -> dict:
    """Device busy time (union of kernel intervals over the GPU streams)
    and the top kernels by summed duration."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    pd = ProfileData.from_file(path)
    spans, per_kernel = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                s0, d = ev.start_ns, ev.duration_ns
                spans.append((s0, s0 + d))
                k = per_kernel.setdefault(ev.name, [0.0, 0])
                k[0] += d
                k[1] += 1
    if not spans:
        raise RuntimeError(f"no GPU stream events in the trace under {trace_dir}")
    spans.sort()
    busy, cur0, cur1 = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    t_lo, t_hi = spans[0][0], max(b for _, b in spans)
    tops = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_busy_s": busy / 1e9,
        "device_span_s": (t_hi - t_lo) / 1e9,
        "top_kernels": [(n, round(v[0] / 1e6, 3), v[1]) for n, v in tops],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=int, default=110)
    args = ap.parse_args()

    import jax

    import oatk_tpu  # noqa: F401

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    import numpy as np

    from oatk_tpu.asm.reads import loader_chunks
    from validate_large import build_genomes, build_reads, write_fa

    work = os.path.join(REPO, "bench_data")
    trace_root = os.path.join(work, "trace")
    os.makedirs(work, exist_ok=True)
    fa = os.path.join(work, f"sel_{args.mbp}.fa")
    rng = np.random.default_rng(20260817)
    mito, pltd = build_genomes(rng)
    write_fa(fa, build_reads(rng, mito, pltd, args.mbp))

    with open(fa, "rb") as f:
        chunks = list(loader_chunks(f.read(), K, S))
    rows = time_chunks(chunks, trace_root)
    sel_s = sum(r["select_device_ms"] * r["chunks"] for r in rows) / 1e3
    ext_s = sum(r["extract_device_ms"] * r["chunks"] for r in rows) / 1e3

    from oatk_tpu.asm.pipeline import syncasm

    kw = dict(k=K, s=S, min_k_cov=30, do_ec=True, do_unzip=3,
              out=os.path.join(work, "sel_asm"), threads=min(16, os.cpu_count() or 1))
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = syncasm([fa], **kw)
        walls.append(time.perf_counter() - t0)
    summary = dict(
        card=card, device_kind=dev.device_kind, mbp=args.mbp, chunks=len(chunks),
        shapes=rows, select_device_s=sel_s, extract_device_s=ext_s,
        syncasm_cold_s=walls[0], syncasm_warm_s=walls[1],
        select_share_of_warm_wall=sel_s / walls[1],
        extract_share_of_warm_wall=ext_s / walls[1],
        warm_stage_walls=res.timings, warm_load_split=res.read_db.load_timings,
    )
    run_trace = os.path.join(trace_root, "syncasm")
    with jax.profiler.trace(run_trace):
        t0 = time.perf_counter()
        syncasm([fa], **kw)
        summary["traced_wall_s"] = time.perf_counter() - t0
    summary["trace"] = reduce_trace(run_trace)
    print(json.dumps(summary, indent=1, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
