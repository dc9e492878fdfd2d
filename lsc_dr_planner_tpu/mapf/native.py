"""ctypes loader for the native C++ MAPF backend (native/mapf.cpp +
native/ecbs.cpp).

Builds the shared library on demand with g++ (cached next to the
sources, keyed on a hash of them), exposes `solve_pibt` and `solve_ecbs` with the same
signatures and identical results as the Python implementations
(shared LCG shuffle for PIBT; strict insertion-counter total orders for
ECBS), and falls back to Python when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from lsc_dr_planner_tpu.mapf import ecbs as pyecbs
from lsc_dr_planner_tpu.mapf import pibt as pypibt

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "mapf.cpp")
_SRC_ECBS = os.path.join(_REPO_ROOT, "native", "ecbs.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libmapf.so")
_STAMP = _LIB + ".sha256"  # digest of the sources the library was built from
_BUILD_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False

# BFS distance-table cache: (occ digest, goal cell) -> [X*Y] int32.
# The tables are the dominant PIBT cost at large fleets (1024 agents x
# 8k cells ~ 400 ms/solve) and goals/grids rarely change between the
# per-step re-solves; keying on a digest of the exact occupancy bytes
# keeps cell unblocking (grid_based_planner.cpp:262-283) correct
# without retaining the raw bytes in every key. Both caches are
# BYTE-bounded (not entry-bounded — at 1024 agents on 8k-cell grids an
# entry-count cap was a multi-GB OOM risk on the 2-core hosts) and
# LOCK-guarded: the Monte-Carlo layer solves scenarios concurrently in
# a thread pool, and an unguarded get()/move_to_end() races popitem().
_BFS_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_BFS_CACHE_MAX_BYTES = 128 * 1024 * 1024
_bfs_cache_bytes = 0
# second level: the STACKED [n, X*Y] table for a whole (occ, goal list)
# — per-step re-solves repeat the same group/goals, so even the 34 MB
# stack assembly at n=1024 is worth skipping
_STACK_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_STACK_CACHE_MAX_BYTES = 256 * 1024 * 1024
_stack_cache_bytes = 0
_CACHE_LOCK = threading.Lock()


def _dist_tables(lib, occ: np.ndarray, goals) -> np.ndarray:
    global _bfs_cache_bytes, _stack_cache_bytes
    X, Y = occ.shape
    key0 = hashlib.blake2b(occ.tobytes(), digest_size=16).digest()
    skey = (key0, tuple(map(tuple, goals)))
    with _CACHE_LOCK:
        hit = _STACK_CACHE.get(skey)
        if hit is not None:
            _STACK_CACHE.move_to_end(skey)
            return hit
    out = np.empty((len(goals), X * Y), dtype=np.int32)
    for i, g in enumerate(goals):
        key = (key0, int(g[0]), int(g[1]))
        with _CACHE_LOCK:
            tab = _BFS_CACHE.get(key)
            if tab is not None:
                _BFS_CACHE.move_to_end(key)
        if tab is None:
            tab = np.empty(X * Y, dtype=np.int32)
            lib.bfs_table(
                occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                X, Y, int(g[0]), int(g[1]),
                tab.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            )
            with _CACHE_LOCK:
                if key not in _BFS_CACHE:
                    _BFS_CACHE[key] = tab
                    _bfs_cache_bytes += tab.nbytes
                    while _bfs_cache_bytes > _BFS_CACHE_MAX_BYTES:
                        _, old = _BFS_CACHE.popitem(last=False)
                        _bfs_cache_bytes -= old.nbytes
        out[i] = tab
    with _CACHE_LOCK:
        if skey not in _STACK_CACHE:
            _STACK_CACHE[skey] = out
            _stack_cache_bytes += out.nbytes
            while _stack_cache_bytes > _STACK_CACHE_MAX_BYTES:
                _, old = _STACK_CACHE.popitem(last=False)
                _stack_cache_bytes -= old.nbytes
    return out


def _source_digest(srcs) -> str:
    """Hash of the C++ sources and the build command: the library is
    rebuilt whenever it differs from the one recorded beside it, so a
    copied or stale binary is never loaded."""
    h = hashlib.sha256(" ".join(_BUILD_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def _build(srcs, digest: str) -> None:
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_BUILD_FLAGS, *srcs, "-o", tmp],
                   check=True, capture_output=True)
    os.replace(tmp, _LIB)
    with open(_STAMP, "w") as f:
        f.write(digest)


def _recorded_digest() -> Optional[str]:
    try:
        with open(_STAMP) as f:
            return f.read().strip()
    except OSError:
        return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        srcs = [s for s in (_SRC, _SRC_ECBS) if os.path.exists(s)]
        digest = _source_digest(srcs)
        if not os.path.exists(_LIB) or _recorded_digest() != digest:
            _build(srcs, digest)
        lib = ctypes.CDLL(_LIB)
        lib.pibt_solve.restype = ctypes.c_int
        lib.pibt_solve.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # occ
            ctypes.c_int, ctypes.c_int,  # X, Y
            ctypes.POINTER(ctypes.c_int),  # starts
            ctypes.POINTER(ctypes.c_int),  # currents
            ctypes.POINTER(ctypes.c_int),  # goals
            ctypes.POINTER(ctypes.c_int),  # init_elapsed
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, seed, max_t
            ctypes.POINTER(ctypes.c_int),  # out_paths
            ctypes.c_int,  # max_len
            ctypes.POINTER(ctypes.c_int),  # dist_in (nullable)
        ]
        lib.bfs_table.restype = None
        lib.bfs_table.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.ecbs_solve.restype = ctypes.c_int
        lib.ecbs_solve.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # occ
            ctypes.c_int, ctypes.c_int,  # X, Y
            ctypes.POINTER(ctypes.c_int),  # currents
            ctypes.POINTER(ctypes.c_int),  # goals
            ctypes.c_int, ctypes.c_double,  # n, w
            ctypes.c_int, ctypes.c_double,  # max_hl_nodes, time_limit_s
            ctypes.POINTER(ctypes.c_int),  # out_paths
            ctypes.c_int,  # max_len
            ctypes.POINTER(ctypes.c_longlong),  # out_lb
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def backend_name() -> str:
    """'native' when the C++ solver library is loaded, else 'python'.

    The two backends are bit-identical in results but ~25× apart in
    speed; runs record which one served them so a silent fallback to
    Python (no g++, compile failure) cannot masquerade as a perf
    regression."""
    return "native" if _load() is not None else "python"


def solve_pibt(
    occ2d: np.ndarray,
    starts: Sequence[Tuple[int, int]],
    currents: Sequence[Tuple[int, int]],
    goals: Sequence[Tuple[int, int]],
    seed: int = 0,
    max_timestep: int = pypibt.MAX_TIMESTEP,
    init_elapsed: Optional[Sequence[int]] = None,
    max_rows: Optional[int] = None,
) -> Optional[List[List[Tuple[int, int]]]]:
    """Native PIBT; falls back to the Python implementation.

    `max_rows`: truncate the RETURNED paths to the first N rows (the
    per-step waypoint layer consumes only row 1; converting 1024
    full-horizon paths to Python tuples dominated the host phase at
    fleet scale). The solve itself always runs to completion, so
    None-vs-paths (solvability) is unaffected."""
    lib = _load()
    if lib is None:
        paths = pypibt.solve_pibt(
            occ2d, starts, currents, goals, seed=seed,
            max_timestep=max_timestep, init_elapsed=init_elapsed,
        )
        if paths is not None and max_rows is not None:
            paths = [row[:max_rows] for row in paths]
        return paths
    occ = np.ascontiguousarray(np.asarray(occ2d, dtype=np.uint8))
    X, Y = occ.shape
    n = len(currents)
    st = np.ascontiguousarray(np.asarray(starts, dtype=np.int32).reshape(-1))
    cu = np.ascontiguousarray(np.asarray(currents, dtype=np.int32).reshape(-1))
    go = np.ascontiguousarray(np.asarray(goals, dtype=np.int32).reshape(-1))
    el = np.ascontiguousarray(
        np.asarray(
            init_elapsed if init_elapsed is not None else np.zeros(n),
            dtype=np.int32,
        )
    )
    max_len = max_timestep + 2
    out = np.zeros((n, max_len, 2), dtype=np.int32)

    def ptr(a, typ=ctypes.c_int):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    dists = np.ascontiguousarray(_dist_tables(lib, occ, goals))
    L = lib.pibt_solve(
        ptr(occ, ctypes.c_uint8), X, Y, ptr(st), ptr(cu), ptr(go), ptr(el),
        n, seed, max_timestep, ptr(out), max_len, ptr(dists),
    )
    if L < 0:
        return None
    # bulk tolist() + tuple(): ~10× faster than per-element int() at
    # 1024 agents × long horizons (the conversion dominated the solve)
    keep = L if max_rows is None else min(L, max_rows)
    return [[tuple(c) for c in row] for row in out[:, :keep].tolist()]


def solve_ecbs(
    occ2d: np.ndarray,
    starts: Sequence[Tuple[int, int]],
    currents: Sequence[Tuple[int, int]],
    goals: Sequence[Tuple[int, int]],
    sub_optimality: float = pyecbs.SUB_OPTIMALITY,
    max_hl_nodes: int = 5000,
    return_lb: bool = False,
    time_limit_s: float = 10.0,
    max_rows: Optional[int] = None,
):
    """Native ECBS; falls back to the Python implementation. `starts`
    is accepted for signature parity (ECBS plans from `currents`)."""
    lib = _load()
    if lib is None:
        return pyecbs.solve_ecbs(
            occ2d, starts, currents, goals,
            sub_optimality=sub_optimality, max_hl_nodes=max_hl_nodes,
            return_lb=return_lb, time_limit_s=time_limit_s,
        )
    occ = np.ascontiguousarray(np.asarray(occ2d, dtype=np.uint8))
    X, Y = occ.shape
    n = len(currents)
    cu = np.ascontiguousarray(np.asarray(currents, dtype=np.int32).reshape(-1))
    go = np.ascontiguousarray(np.asarray(goals, dtype=np.int32).reshape(-1))
    max_len = 4 * (X + Y) * n + 100
    out = np.zeros((n, max_len, 2), dtype=np.int32)
    lb = ctypes.c_longlong(0)

    def ptr(a, typ=ctypes.c_int):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    T = lib.ecbs_solve(
        ptr(occ, ctypes.c_uint8), X, Y, ptr(cu), ptr(go), n,
        ctypes.c_double(sub_optimality), max_hl_nodes,
        ctypes.c_double(time_limit_s), ptr(out), max_len,
        ctypes.byref(lb),
    )
    if T < 0:
        paths = None
    else:
        keep = T if max_rows is None else min(T, max_rows)
        paths = [
            [tuple(int(v) for v in out[i, t]) for t in range(keep)]
            for i in range(n)
        ]
    if return_lb:
        return paths, int(lb.value)
    return paths
