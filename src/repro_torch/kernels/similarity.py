"""Strict-similarity marking pass (K4) for the H100: the hot spot of the
recovery rounds' marking step (pdGRASS step 4).

The port of ``repro.kernels.similarity``.  With the ancestor-signature
reduction (:mod:`repro_torch.core.lifting`), recovered candidate ``k``
marks edge ``j`` iff

    (u_j in S(u_k) and v_j in S(v_k)) or (u_j in S(v_k) and v_j in S(u_k))

where ``x in S(y)`` is ``exists a + b <= beta_k: sig_y[k, a] == sig_x[j, b]``
— a fixed ``(c+1)^2`` grid of int32 equality tests, pairs with
``a + b > c`` skipped.

:func:`similarity_mark` launches the hand-written CUDA kernels
(``kernels/csrc/similarity_mark.cu``: the row stream, then the (row,
candidate) pairs it lists) when its tensors lie on a CUDA device and runs
the plain version (:func:`repro_torch.kernels.ref.similarity_mark_ref`)
when they lie on the CPU.  Each launch adds one to its count in
:data:`repro_torch.kernels._launch.launches`.

The list of rows that the row stream hands to the second kernel lives in
one scratch buffer a (device, stream) (:data:`ROW_CAPACITY` rows, 8 MB),
zeroed when first made.  The launches that share a buffer number
themselves so that each leaves the next one a zero count, which holds
only if they reach the stream in the order of their numbers: a launch
takes its number and is enqueued under the buffer's lock, so builds on
several threads may share a stream.  Launches on two streams are not
ordered on the device, so each stream has a buffer of its own.  A warp
whose rows do not fit walks them itself, so the result never depends on
the capacity.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import count, on_cuda, require, stream

_MAX_C1 = 16   # the CUDA kernel's template instances cover c1 = 1..16
ROW_CAPACITY = 1 << 21    # rows the device list holds


class _RowScratch:
    """One (device, stream)'s row list, its two counters and the number of
    its last launch."""

    def __init__(self, device):
        self.buf = torch.zeros(2 + ROW_CAPACITY, dtype=torch.int32,
                               device=device)
        # lock: self._lock
        #   _epoch
        self._lock = threading.Lock()
        self._epoch = 0

    def launch(self, enqueue):
        """``enqueue(scratch pointer, launch number)`` under the lock, so
        that the launches reach the stream in the order of their numbers.
        The lock covers the host-side enqueue only, never a sync."""
        with self._lock:
            self._epoch += 1
            return enqueue(self.buf.data_ptr(), self._epoch & 0x3FFFFFFF)


_scratch: dict = {}       # (device, stream handle) -> _RowScratch
_scratch_made = threading.Lock()


def _row_scratch(device, stream_handle) -> _RowScratch:
    key = (device, stream_handle)
    with _scratch_made:
        entry = _scratch.get(key)
        if entry is None:
            entry = _scratch[key] = _RowScratch(device)
    return entry


def similarity_mark(csu, csv, cbeta, cseg, esu, esv, eseg):
    """``kill[j]`` = some candidate of edge ``j``'s subtask marks it.

    Args:
      csu/csv: [K, c1] int32 candidate signatures (``cbeta < 0`` disables
               a row).
      cbeta:   [K] int32.
      cseg:    [K] int32 subtask ids.
      esu/esv: [m, c1] int32 edge signatures, any ``m``.
      eseg:    [m] int32 (``-1`` for padding rows).
    Returns: [m] bool.
    """
    if not on_cuda(csu, csv, cbeta, cseg, esu, esv, eseg):
        return _ref.similarity_mark_ref(csu, csv, cbeta, cseg, esu, esv,
                                        eseg)
    from repro_torch.kernels._build import check, library

    for name, t, nd in (("csu", csu, 2), ("csv", csv, 2), ("cbeta", cbeta, 1),
                        ("cseg", cseg, 1), ("esu", esu, 2), ("esv", esv, 2),
                        ("eseg", eseg, 1)):
        require(t, name, torch.int32, nd)
    K, c1 = csu.shape
    m = esu.shape[0]
    if (csv.shape != csu.shape or cbeta.shape != (K,) or cseg.shape != (K,)
            or esu.shape[1] != c1 or esv.shape != esu.shape
            or eseg.shape != (m,)):
        raise ValueError(
            "similarity_mark: shapes do not agree: csu/csv "
            f"{tuple(csu.shape)}/{tuple(csv.shape)}, cbeta/cseg "
            f"{tuple(cbeta.shape)}/{tuple(cseg.shape)}, esu/esv "
            f"{tuple(esu.shape)}/{tuple(esv.shape)}, eseg {tuple(eseg.shape)}")
    if not 1 <= c1 <= _MAX_C1:
        raise ValueError(f"similarity_mark takes 1 <= c1 <= {_MAX_C1}, "
                         f"got {c1}")
    out = torch.empty((m,), dtype=torch.bool, device=esu.device)
    if m == 0:   # the library launches nothing: take no launch number
        return out
    lib, s = library(), stream()
    check(_row_scratch(esu.device, s).launch(
        lambda scratch, epoch: lib.repro_similarity_mark(
            csu.data_ptr(), csv.data_ptr(), cbeta.data_ptr(),
            cseg.data_ptr(), esu.data_ptr(), esv.data_ptr(), eseg.data_ptr(),
            out.data_ptr(), K, m, c1, scratch, ROW_CAPACITY, epoch, s)),
        "similarity_mark")
    count("similarity_mark")
    return out
