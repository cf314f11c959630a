"""K4 inputs laid out to reach each part of the CUDA kernel
(``kernels/csrc/similarity_mark.cu``): many subtasks in one warp, one
subtask with many candidates (thousands of pairs in a block: the rows
kernel), K of one, over one and over two candidate tiles, ragged row
counts, c1 at both ends, no recovered candidate, padding rows beside
invalid candidates, and subtask ids far apart and at the int32 extremes.
Drawn with numpy from a seed, so the CPU tests (against the reference)
and the card's tests (against the plain version) see the same arrays.
Candidates are never sorted by subtask.
"""
import numpy as np

K4_LAYOUTS = ("warp_in_32_subtasks", "128_in_one_subtask", "K1", "K129",
              "K300", "m1", "m_ragged", "c1_1", "c1_9", "c1_16",
              "no_recovered", "padding_beside_invalid", "wide_subtask_ids")


def _sorted_rows(rng, m, n_seg, pad):
    """Rows ordered by subtask as the round engine orders them, with the
    padding rows (-1) at the end."""
    eseg = np.sort(rng.integers(0, n_seg, size=m)).astype(np.int32)
    eseg[m - pad:] = -1
    return eseg


def k4_layout(name: str, seed: int = 0):
    """``(csu, csv, cbeta, cseg, esu, esv, eseg)`` int32 arrays of one
    layout; signatures drawn from an alphabet of 24 values (300 where one
    subtask has 128 candidates), so that some rows are marked and some
    are not."""
    rng = np.random.default_rng(seed + K4_LAYOUTS.index(name))
    K, c1, alphabet = 128, 9, 24
    if name == "warp_in_32_subtasks":
        # the first warp's 32 threads (16 rows each) in 32 subtasks, then
        # 32 single-row subtasks, then runs of 7 rows; 2 recovered
        # candidates in each of the first 64 subtasks
        m = 4096 + 700
        eseg = np.concatenate([np.arange(512) // 16, 32 + np.arange(32),
                               64 + np.arange(m - 544 - 100) // 7,
                               np.full(100, -1)]).astype(np.int32)
        cseg = rng.permutation(np.repeat(np.arange(64), 2)).astype(np.int32)
        cbeta = rng.integers(0, c1, size=K).astype(np.int32)
    elif name == "128_in_one_subtask":
        m = 5000
        eseg = (np.arange(m) // 50).astype(np.int32)
        eseg[1000:1600] = 20                # subtask 20 holds 600 rows
        cseg = np.full(K, 20, np.int32)
        cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
        alphabet = 300
    elif name in ("K1", "K129", "K300"):
        K, m = int(name[1:]), 3000
        eseg = _sorted_rows(rng, m, 150, 100)
        cseg = rng.integers(0, 150, size=K).astype(np.int32)
        cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
    elif name == "m1":
        K, m = 8, 1
        eseg = np.zeros(1, np.int32)
        cseg = rng.integers(0, 2, size=K).astype(np.int32)
        cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
    elif name == "m_ragged":
        # past two whole blocks by 37 rows: neither 16 nor 4096 divides m
        K, m = 64, 2 * 4096 + 37
        eseg = _sorted_rows(rng, m, 200, 20)
        cseg = rng.integers(0, 200, size=K).astype(np.int32)
        cseg[:8] = eseg[-21]                # candidates of the last rows
        cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
    elif name in ("c1_1", "c1_9", "c1_16"):
        c1, m = int(name[3:]), 3000
        eseg = _sorted_rows(rng, m, 150, 100)
        cseg = rng.integers(0, 150, size=K).astype(np.int32)
        cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
    elif name == "no_recovered":
        m = 5000
        eseg = _sorted_rows(rng, m, 100, 100)
        cseg = rng.integers(0, 100, size=K).astype(np.int32)
        cbeta = np.full(K, -1, np.int32)
    elif name == "padding_beside_invalid":
        # padding runs between subtasks; invalid candidates (cseg = -2, as
        # the engine fills them) with and without a beta, and candidates of
        # the padding rows' id -1
        m = 4500
        eseg = (np.arange(m) // 9).astype(np.int32)
        eseg[(np.arange(m) % 90) >= 81] = -1
        cseg = rng.integers(0, m // 9, size=K).astype(np.int32)
        cseg[:40] = -2
        cseg[40:50] = -1
        cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
        cbeta[:20] = -1
    elif name == "wide_subtask_ids":
        # ids far apart, and the int32 extremes as subtask ids
        m = 5000
        ids = np.sort(rng.choice(10**6, size=300, replace=False))
        eseg = np.sort(rng.choice(ids, size=m)).astype(np.int32)
        eseg[:20], eseg[-20:] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        cseg = rng.choice(eseg, size=K).astype(np.int32)
        cseg[:4] = eseg[0], eseg[0], eseg[-1], eseg[-1]
        cbeta = rng.integers(-1, c1, size=K).astype(np.int32)
    else:
        raise ValueError(f"unknown K4 layout {name!r}")
    sig = lambda r: rng.integers(0, alphabet, size=(r, c1)).astype(np.int32)
    return sig(K), sig(K), cbeta, cseg, sig(m), sig(m), eseg
