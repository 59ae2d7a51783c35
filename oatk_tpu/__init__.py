"""oatk-tpu: an accelerator-native organelle genome assembly engine.

A from-scratch JAX/XLA rebuild of the capabilities of c-zhou/oatk
(HiFi closed-syncmer sparse de Bruijn assembly -> HMM annotation ->
organelle classification and circular path search).

The compute-heavy stages (per-base syncmer scan, k-mer counting) run as
vectorized XLA programs over batched, padded read tensors on the GPU;
the small-N graph stages (unitigging, cleaning, path search) and the
banded edit-distance error correction run on host NumPy / native C,
fed by device reductions.

Reference parity targets c-zhou/oatk @ 2025-02-25 (see SURVEY.md).
"""

__version__ = "0.1.0"

# 64-bit integers are required throughout (smer codes use up to 62 bits,
# Murmur k-mer hashes are 64-bit).
# Floats stay explicitly f32/f64 per use site; enabling x64 here only
# changes integer behavior for arrays we construct with explicit dtypes.
import jax as _jax

_jax.config.update("jax_enable_x64", True)

import os as _os

# Disable numpy's MADV_HUGEPAGE on large allocations.  On kernels where
# transparent hugepages are slow to fault/collapse (measured here: first
# touch of a THP-advised region runs ~150x slower than 4K pages -- 30 s
# vs 0.2 s per 200 MB), every fresh large array pays a massive hidden
# tax; the assembler's host stages are allocation-heavy (flat
# concatenations, read batches), so this single switch dominates
# end-to-end wall clock.  Runtime switch (not the NUMPY_MADVISE_HUGEPAGE
# env var) so it works regardless of import order.
if _os.environ.get("OATK_TPU_HUGEPAGE", "0") != "1":
    try:
        try:
            from numpy._core.multiarray import _set_madvise_hugepage as _smh
        except ImportError:  # pragma: no cover - numpy < 2
            from numpy.core.multiarray import _set_madvise_hugepage as _smh
        _smh(False)
    except Exception:  # pragma: no cover - private symbol moved/removed
        pass  # purely a perf tweak; never block the import

# Keep large allocations on the reusable brk heap.  On microVM kernels
# (Firecracker here) EVERY newly faulted anonymous page takes a host
# roundtrip -- measured 5-8 s/GB first touch, and parallel faulting is
# WORSE (41 s/GB across 4 threads).  glibc mmaps allocations above
# M_MMAP_THRESHOLD (128 KB default) and munmaps them on free, so each
# big numpy temporary re-pays the full fault cost; raising the
# threshold (and the trim threshold, so the heap top is not returned)
# makes freed pages reusable: repeat 800 MB alloc+touch drops 6.8 s ->
# 0.4 s.  Values are clamped to INT_MAX (mallopt takes int).
if _os.environ.get("OATK_TPU_MALLOC_REUSE", "1") == "1":
    try:
        import ctypes as _ct

        _libc = _ct.CDLL("libc.so.6")
        _libc.mallopt(-3, 0x7FFFFFFF)  # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 0x7FFFFFFF)  # M_TRIM_THRESHOLD
    except Exception:  # pragma: no cover - non-glibc libc
        pass

# Persistent XLA compilation cache: the syncmer kernels compile once per
# (batch, length-bucket) shape; caching across processes makes repeat
# CLI invocations skip those compiles.  JAX_COMPILATION_CACHE_DIR, when
# set, is read by JAX itself and nothing is set here; otherwise the cache
# lives at a fixed path inside the checkout (the path is part of the
# cache key, so it must not move between runs).
CACHE_DIR_DEFAULT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
# CPU-only runs skip the cache: XLA:CPU persists AOT code whose machine
# features may not match a later host (it warns about possible SIGILL),
# and CPU compiles are cheap anyway.
if "cpu" not in _os.environ.get("JAX_PLATFORMS", "").lower() and not _os.environ.get(
    "JAX_COMPILATION_CACHE_DIR"
):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR_DEFAULT)
