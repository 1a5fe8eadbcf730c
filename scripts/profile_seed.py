"""Stage timing of the device seeding kernel at the bench aligner shapes
(k13/w5, 8 Mb genome, 4000-read mu=400 batch)."""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import jax

from bossruns_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()

import jax.numpy as jnp
from functools import partial

from bossruns_tpu.aligner import encode
from bossruns_tpu.aligner.index import build_index
from bossruns_tpu.aligner.seed import (DeviceIndex, _lookup_join, _vote,
                                       anchor_budget, compact_minimizers,
                                       pack_reads, read_minimizers,
                                       unpack_reads, _seed_topn_jit, OCC_CAP,
                                       SENTINEL)
from bossruns_tpu.utils.datagen import random_genome


def timeit(fn, n=5, name=""):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    print(f"{name:32s} {float(np.median(ts))*1e3:8.2f} ms", flush=True)


def main():
    rng = np.random.default_rng(2)
    k, w = 13, 5
    genome = random_genome(rng, {"c1": 4_050_000, "c2": 2_000_000, "c3": 2_000_000})
    seq_int = np.concatenate([encode(s) for s in genome.values()])
    idx = build_index(seq_int, np.ones(seq_int.shape[0], bool), k=k, w=w)
    print("index: keys", idx.keys.shape[0], "positions", idx.positions.shape[0])
    dev = DeviceIndex(idx)
    print("padded keys", dev.keys.shape[0], "pos_packed", dev.pos_packed.shape)

    L = 512
    R = 4096
    mat = np.full((R, L), 4, np.int8)
    for r in range(R):
        st = rng.integers(0, seq_int.shape[0] - 500)
        mat[r, :400] = seq_int[st : st + 400]
    packed_host = pack_reads(mat)
    packed = jax.device_put(packed_host)
    budget = anchor_budget(L, w)
    print("budget", budget)

    # full kernel
    timeit(lambda: _seed_topn_jit(packed, dev.keys, dev.pos_packed, k, w,
                                  budget, L, 4), name="full _seed_topn_jit")

    @partial(jax.jit, static_argnames=("k", "w"))
    def s_minimizers(packed, k, w):
        reads = unpack_reads(packed, L)
        c, s, m = read_minimizers(reads, k, w)
        return c.sum() + s.sum() + m.sum()
    timeit(lambda: s_minimizers(packed, k, w), name="1 read_minimizers")

    @partial(jax.jit, static_argnames=("k", "w", "budget"))
    def s_compact(packed, k, w, budget):
        reads = unpack_reads(packed, L)
        canonical, strand, is_min = read_minimizers(reads, k, w)
        ck, cs, cpos, cvalid = compact_minimizers(canonical, strand, is_min, budget)
        return ck.sum() + cs.sum() + cpos.sum()
    timeit(lambda: s_compact(packed, k, w, budget), name="2 + compact (scalar)")

    @partial(jax.jit, static_argnames=("k", "w", "budget"))
    def s_compact_full(packed, k, w, budget):
        reads = unpack_reads(packed, L)
        canonical, strand, is_min = read_minimizers(reads, k, w)
        return compact_minimizers(canonical, strand, is_min, budget)
    ck, cs, cpos, cvalid = s_compact_full(packed, k, w, budget)

    @jax.jit
    def s_lookup(keys, ck, cvalid):
        h, r = _lookup_join(keys, ck.reshape(-1), cvalid.reshape(-1))
        return h.sum() + r.sum()
    timeit(lambda: s_lookup(dev.keys, ck, cvalid), name="3 lookup sort-join")

    @jax.jit
    def s_lookup_full(keys, ck, cvalid):
        return _lookup_join(keys, ck.reshape(-1), cvalid.reshape(-1))
    hit_f, rank_f = s_lookup_full(dev.keys, ck, cvalid)

    @jax.jit
    def s_fetch_vote(pos_packed, rank_f, hit_f, ck, cs, cpos):
        r, a = ck.shape
        hit = hit_f.reshape(r, a)
        packed = pos_packed[rank_f.reshape(r, a)]
        occ_ok = hit[:, :, None] & (packed != jnp.uint32(0xFFFFFFFF))
        gpos = (packed >> 1).astype(jnp.int32)
        gstrand = (packed & 1).astype(jnp.int32)
        same = gstrand == cs[:, :, None]
        diag_f = gpos - cpos[:, :, None]
        diag_r = gpos + cpos[:, :, None]
        key_f0 = jnp.where(occ_ok & same, diag_f, SENTINEL).reshape(r, a * OCC_CAP)
        key_r0 = jnp.where(occ_ok & ~same, diag_r, SENTINEL).reshape(r, a * OCC_CAP)
        rp0 = jnp.broadcast_to(cpos[:, :, None], (r, a, OCC_CAP)).reshape(r, a * OCC_CAP)
        cw = (a * OCC_CAP) // 2
        key_fr, rp_fr = (
            x[:, :cw] for x in jax.lax.sort(
                (jnp.concatenate([key_f0, key_r0], axis=0),
                 jnp.concatenate([rp0, rp0], axis=0)), num_keys=1, dimension=1))
        votes = _vote(key_fr)
        return votes.sum()
    timeit(lambda: s_fetch_vote(dev.pos_packed, rank_f, hit_f, ck, cs, cpos),
           name="4 fetch+compact-sort+vote")


if __name__ == "__main__":
    main()
