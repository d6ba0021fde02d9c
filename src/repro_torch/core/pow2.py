"""Shared power-of-two helpers (host-side shape/bucket arithmetic).

A copy of `repro.core.pow2`: `next_pow2` for buffer caps, `log2_ceil`
for table depths (binary-lifting levels) and `auto_chunk` for the
phase-1 block size. The port keeps its own copy so it never imports the
JAX package.
"""
from __future__ import annotations

# Largest power of two representable as a (positive) int32 — the hard
# ceiling for every pow2 pad target / bucket size that ends up as an
# int32 shape constant or index on device; `next_pow2` enforces it.
MAX_POW2_INT32 = 1 << 30


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (x >= 1), int32-safe.

    Raises for x > MAX_POW2_INT32: the next bucket would overflow the
    int32 shape/index arithmetic every consumer of these pad targets
    performs on device.
    """
    if x > MAX_POW2_INT32:
        raise ValueError(
            f"pow2 bucket for {x} exceeds MAX_POW2_INT32={MAX_POW2_INT32}")
    p = 1
    while p < x:
        p <<= 1
    return p


def log2_ceil(n: int) -> int:
    """Smallest k >= 1 with 2**k >= n.

    The floor of 1 matters: binary-lifting tables always carry at least
    one level so the climb loops are well-formed for trivial trees.
    """
    k = 1
    while (1 << k) < n:
        k += 1
    return k


def auto_chunk(m: int, lo: int = 8, hi: int = 64) -> int:
    """Power-of-two block size ~ sqrt(m), clamped to [lo, hi].

    The chunked schedulers (phase-1 marking, recovery replay) pay one
    batched LCA per block of C slots plus a C-step arithmetic inner
    scan, so per-block cost grows ~C^2 while the step count shrinks as
    m/C; C ~ sqrt(m) balances the two, and the pow2 grid keeps the
    number of distinct compiled shapes small across serving buckets.
    """
    c = lo
    while c < hi and c * c < m:
        c <<= 1
    return c
