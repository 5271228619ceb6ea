"""CompactVector (paper §5.3, Alg. 4): run-length sparse vector storage
(the port's own copy of ``repro/core/compactvector.py``, host-side numpy).

Representation of a length-``size`` vector: a ``values`` array holding the
non-empty elements in order, plus an index array of (s, n) pairs where ``s``
is the starting index of an *empty* run and ``n`` is the number of non-empty
elements strictly before position ``s``. GetValue is O(log N) in the number
of runs N (<= number of nonzeros E, so never worse than SparseVector's
O(log E); smaller whenever nonzeros cluster into runs, E/N >= 2).

The sampling paths use fixed-shape padded-sparse rows instead
(``core.zen_sparse``); CompactVector is host-side, as in the paper (JVM).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class CompactVector:
    size: int
    empty_starts: np.ndarray  # (N,) int — start index of each empty run
    nnz_before: np.ndarray  # (N,) int — non-empty count before that start
    values: np.ndarray  # (E,) the non-empty values in order

    @staticmethod
    def from_dense(dense: Sequence) -> "CompactVector":
        dense = np.asarray(dense)
        size = dense.shape[0]
        nz = dense != 0
        values = dense[nz]
        empty_starts: List[int] = []
        nnz_before: List[int] = []
        count = 0
        in_empty = False
        for i in range(size):
            if nz[i]:
                count += 1
                in_empty = False
            else:
                if not in_empty:
                    empty_starts.append(i)
                    nnz_before.append(count)
                    in_empty = True
        return CompactVector(
            size=size,
            empty_starts=np.asarray(empty_starts, dtype=np.int64),
            nnz_before=np.asarray(nnz_before, dtype=np.int64),
            values=values,
        )

    def get(self, x: int):
        """Paper Alg. 4 GetValue: O(log N) binary search over empty runs."""
        if not (0 <= x < self.size):
            raise IndexError(x)
        if self.empty_starts.size == 0:
            return self.values[x]
        # position of the last empty-run start <= x
        j = bisect.bisect_right(self.empty_starts.tolist(), x) - 1
        if j < 0:
            # before any empty run: x indexes values directly
            return self.values[x]
        s_j = int(self.empty_starts[j])
        n_j = int(self.nnz_before[j])
        # length of empty run j = (index of next nonzero) - s_j; x is inside
        # run j iff fewer than (x - s_j + 1) nonzeros materialized after s_j.
        # Number of nonzeros at positions < x is n_j + max(0, x - (s_j + run_len))
        # Compute run length from the next run's bookkeeping:
        if j + 1 < self.empty_starts.size:
            nnz_next = int(self.nnz_before[j + 1])
            next_start = int(self.empty_starts[j + 1])
            run_len = (next_start - s_j) - (nnz_next - n_j)
        else:
            total_nnz = int(self.values.size)
            run_len = (self.size - s_j) - (total_nnz - n_j)
        if x < s_j + run_len:
            return self.values.dtype.type(0)
        return self.values[n_j + (x - (s_j + run_len))]

    def to_dense(self) -> np.ndarray:
        return np.array([self.get(i) for i in range(self.size)])

    def nbytes(self) -> int:
        return int(
            self.empty_starts.nbytes + self.nnz_before.nbytes + self.values.nbytes
        )

    def insert(self, x: int, value) -> "CompactVector":
        """O(N + E) insert (paper: 'insertion is much costly with O(N)')."""
        dense = self.to_dense()
        dense[x] = value
        return CompactVector.from_dense(dense)
