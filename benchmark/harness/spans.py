"""The benchmark's own records around calls into the port's layers, taken
where the port looks the callee up and only in traced runs.

`K1Launches` records the shapes of every call of K1's entry
(`ops.sw_cuda.sw_score_cuda`) that the align step (`pipeline.align`) makes:
(pairs, query length L, window length W, rows swept)."""

from __future__ import annotations


class K1Launches:
    def __init__(self):
        self.launches: list = []

    def _call(self, q, w, sc, rows=0):
        n, L = q.shape
        W = w.shape[1]
        self.launches.append((int(n), int(L), int(W),
                              int(rows) if rows and rows < L else int(L)))
        return self._real(q, w, sc, rows=rows)

    def __enter__(self):
        from rambl_tpu_torch.pipeline import align

        self._mod = align
        self._real = align.sw_score_cuda
        align.sw_score_cuda = self._call
        return self

    def __exit__(self, *exc):
        self._mod.sw_score_cuda = self._real
        return False
