"""DP-means' center recount on the CPU: `ops.cluster_cuda.dp_recount_centers`
on CPU tensors runs its plain version, `pipeline.cluster.recount_centers`,
and launches nothing; both equal a count written out member by member.
The kernel itself runs only on a card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from rambl_tpu_torch.ops import cluster_cuda
from rambl_tpu_torch.pipeline import cluster as tcluster


def _brute(feat, assign, fallback, kact, K):
    NL, M, P = feat.shape
    out = np.zeros((NL, K, P), np.int8)
    for a in range(NL):
        for k in range(int(kact[a])):
            for p in range(P):
                col = feat[a, assign[a] == k, p]
                cnt = [int((col == b).sum()) for b in range(4)]
                out[a, k, p] = (int(np.argmax(cnt)) if sum(cnt)
                                else fallback[a, p])
    return out


@pytest.mark.parametrize("NL,M,P,K", [(3, 40, 16, 4), (1, 29, 37, 5)])
def test_recount_centers_on_cpu_runs_the_twin(NL, M, P, K):
    rng = np.random.default_rng(NL * 100 + M)
    feat = np.where(rng.random((NL, M, P)) < 0.5,
                    rng.integers(0, 4, (NL, M, P)), -1).astype(np.int8)
    feat[0, :, 0] = np.arange(M) % 2 + 1          # a tie of bases 1 and 2
    assign = rng.integers(0, K, (NL, M)).astype(np.int32)
    assign[0] = np.minimum(assign[0], K - 2)      # cluster K - 1 is empty
    fallback = rng.integers(0, 4, (NL, P)).astype(np.int8)
    kact = np.full(NL, K, np.int32)
    kact[-1] = K - 2                              # inactive clusters
    args = [torch.from_numpy(x) for x in (feat, assign, fallback, kact)]
    cluster_cuda.reset_launches()
    got = cluster_cuda.dp_recount_centers(*args, K)
    assert cluster_cuda.LAUNCHES["recount"] == 0
    assert got.dtype == torch.int8 and got.shape == (NL, K, P)
    assert torch.equal(got, tcluster.recount_centers(*args, K))
    np.testing.assert_array_equal(got.numpy(),
                                  _brute(feat, assign, fallback, kact, K))
