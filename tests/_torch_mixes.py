"""Δ mixes of the port's kernel tests: int8 (x_t, x_prev) pairs made with
numpy from a seed, whose Δ = x_t - x_prev sits on the tile-class
boundaries {0, 7, 8}. Shared by tests/test_torch_kernels.py and
tests/test_torch_fused.py."""
import numpy as np


def lone_delta(shape):
    """One non-zero lane a 128 x 128 tile of the 128-padded grid, 7 or 8
    alternating by tile, its sign alternating every two tiles, every fifth
    tile all zero; the lane's row walks the first and last rows of the
    16-row slabs (a block edge at every encode cluster size), its column
    the tile. Cropped to ``shape``, so a lane in the padding leaves its
    tile all zero."""
    m, k = shape
    gm, gk = -(-m // 128), -(-k // 128)
    rows = [r for s in range(8) for r in (16 * s, 16 * s + 15)]
    d = np.zeros((gm * 128, gk * 128), np.int32)
    for t in range(gm * gk):
        d[t // gk * 128 + rows[t % 16], t % gk * 128 + t * 37 % 128] = (
            (7 + t % 2) * (1 - 2 * (t // 2 % 2)) * (t % 5 != 4))
    return d[:m, :k]


def delta_pair(rng, shape, mix):
    """(x_t, x_prev) int8 whose Δ follows ``mix``: zero | low (|Δ| <= 7) |
    edge (|Δ| in {7, 8}) | lone (one lane decides a tile) | full."""
    x_t = rng.integers(-100, 101, size=shape).astype(np.int8)
    if mix == "lone":
        d = lone_delta(shape)
    elif mix == "zero":
        d = np.zeros(shape, np.int32)
    elif mix == "low":
        d = rng.integers(-7, 8, size=shape)
    elif mix == "edge":
        d = rng.choice([-8, -7, 7, 8], size=shape)
    else:
        d = rng.integers(-254, 255, size=shape)
    return x_t, np.clip(x_t.astype(np.int32) - d, -127, 127).astype(np.int8)
