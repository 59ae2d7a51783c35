"""Multi-device sharding: data-parallel syncmer extraction + hash-sharded
k-mer count merge over a 1-D jax.sharding.Mesh.

The reference's parallelism is reads-only (pthreads, SURVEY.md 2.2);
the device scale-out axes are
  - reads   -> batch ('d') data parallelism (each device scans a shard
               of the padded read batch), and
  - k-mer hash space -> ownership sharding: every extracted k-mer hash
    is routed to its owner device (top hash bits) with an all_to_all so
    each device builds the count table for its slice of hash space; a
    psum merges the global histogram used for the auto coverage cutoff.

One fused jit program per step; the collectives run between the mesh
devices (all to all, so the mesh follows the algorithm alone).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels.syncmer import extract_syncmers_batch


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} shards but only {len(devs)} device(s) "
                f"are visible (set XLA_FLAGS=--xla_force_host_platform_device_count "
                f"for virtual CPU meshes)"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _local_extract(seq, lens, w: int, s: int, max_out: int):
    out = extract_syncmers_batch(seq, lens, w, s, max_out)
    return out["sel_khash"], out["valid"], out["n_sel"]


@partial(jax.jit, static_argnames=("w", "s", "max_out", "mesh", "bucket_cap"))
def sharded_extract_count_step(
    seq: jnp.ndarray,  # [B, L] uint8, B divisible by mesh size
    lens: jnp.ndarray,  # [B] int32
    w: int,
    s: int,
    max_out: int,  # per-shard extraction capacity
    mesh: Mesh,
    bucket_cap: int,  # per-(shard,dest) routing capacity
):
    """One sharded extract+count step.

    Returns (n_distinct[D], hist[D, 64], n_sel[D], n_dropped[D]) where
    hist is the globally-psummed k-mer multiplicity histogram and
    n_distinct counts distinct k-mers owned per shard.  Routing
    capacity overflows are *counted* (n_dropped), never silent.
    """
    D = mesh.devices.size
    ax = mesh.axis_names[0]

    def step(seq_l, lens_l):
        khash, valid, n_sel = _local_extract(seq_l[0], lens_l[0], w, s, max_out)
        # owner = top bits of the hash
        owner = (khash >> jnp.uint64(64 - max(1, (D - 1).bit_length()))).astype(jnp.int32)
        owner = jnp.minimum(owner, D - 1)
        owner = jnp.where(valid, owner, D)  # invalid -> dropped lane

        # build fixed-capacity routing buckets [D, cap]
        order = jnp.argsort(owner, stable=True)
        sorted_owner = owner[order]
        sorted_hash = khash[order]
        start = jnp.searchsorted(sorted_owner, jnp.arange(D, dtype=jnp.int32))
        end = jnp.searchsorted(sorted_owner, jnp.arange(1, D + 1, dtype=jnp.int32))
        cnt = end - start
        n_dropped = jnp.sum(jnp.maximum(cnt - bucket_cap, 0))
        idx = start[:, None] + jnp.arange(bucket_cap)[None, :]
        in_range = jnp.arange(bucket_cap)[None, :] < jnp.minimum(cnt, bucket_cap)[:, None]
        buckets = jnp.where(
            in_range,
            sorted_hash[jnp.clip(idx, 0, max_out - 1)],
            jnp.uint64(0xFFFFFFFFFFFFFFFF),
        )  # [D, cap]

        # exchange: bucket d goes to shard d
        recv = lax.all_to_all(buckets[None], ax, split_axis=1, concat_axis=0)
        mine = recv.reshape(-1)  # [D*cap] hashes owned by this shard

        # local count table: sort + run-length
        ms = jnp.sort(mine)
        sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        valid_m = ms != sentinel
        newrun = jnp.concatenate([jnp.ones(1, bool), ms[1:] != ms[:-1]]) & valid_m
        n_distinct = jnp.sum(newrun, dtype=jnp.int32)
        # multiplicity histogram (counts clipped at 63)
        run_id = jnp.cumsum(newrun) - 1
        counts = jax.ops.segment_sum(
            valid_m.astype(jnp.int32), run_id, num_segments=mine.shape[0]
        )
        cc = jnp.clip(counts, 0, 63)
        hist_local = jnp.zeros(64, jnp.int32).at[cc].add((counts > 0).astype(jnp.int32))
        hist = lax.psum(hist_local, ax)
        return (
            n_distinct[None],
            hist[None],
            n_sel[None],
            n_dropped[None],
        )

    from jax import shard_map

    return shard_map(
        step,
        mesh=mesh,
        in_specs=(P(ax, None, None), P(ax, None)),
        out_specs=(P(ax), (P(ax, None)), P(ax), P(ax)),
        check_vma=False,
    )(seq.reshape(D, -1, seq.shape[1]), lens.reshape(D, -1))
