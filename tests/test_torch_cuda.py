"""The port's CUDA kernels against their plain twins on the card, bitwise.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips with a
reason where ``torch.cuda.is_available()`` is false.  The file imports
nothing of JAX, so it runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batcheval
from repro_torch.core.diameter import adjacency_from_rings
from repro_torch.core.topology import make_latency
from repro_torch.kernels.minplus import kernel, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ring_adj(dist, n, seed, k_rings):
    rng = np.random.default_rng(seed)
    w = make_latency(dist, n, seed=seed)
    return adjacency_from_rings(w, [rng.permutation(n)
                                    for _ in range(k_rings)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 13, 17, 29), (3, 20, 33, 17),
                                   (1, 5, 130, 7), (2, 256, 256, 256)])
def test_minplus_acc_bitwise(cuda, dtype, shape):
    bsz, m, k, n = shape
    rng = np.random.default_rng(sum(shape))

    def rand(*s):
        return torch.from_numpy(rng.uniform(0, 10, s).astype(np.float32)) \
            .to(cuda, dtype)

    a, b, c = rand(bsz, m, k), rand(bsz, k, n), rand(bsz, m, n)
    before = kernel.launches["minplus_acc"]
    assert torch.equal(kernel.minplus_acc(a, b), ref.minplus_acc_ref(a, b))
    assert torch.equal(kernel.minplus_acc(a, b, c),
                       ref.minplus_acc_ref(a, b, c))
    out = c.clone()
    kernel.minplus_acc(a, b, init=out, out=out)
    assert torch.equal(out, ref.minplus_acc_ref(a, b, c))
    assert kernel.launches["minplus_acc"] == before + 3


@pytest.mark.parametrize("shape", [(13, 17, 29), (5, 130, 7), (45, 70, 31)])
def test_ops_minplus_unpadded_ragged_bitwise(cuda, shape):
    """ops.minplus / minplus_batched hand ragged operands to K1 as they
    are: K1 masks the edges itself."""
    m, k, n = shape
    rng = np.random.default_rng(m * k * n)
    a = rng.uniform(0, 10, (2, m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (2, k, n)).astype(np.float32)
    a_c, b_c = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    want = ref.minplus_batched_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(ops.minplus_batched(a_c, b_c).cpu(), want)
    assert torch.equal(ops.minplus(a_c[0], b_c[0]).cpu(), want[0])


def test_minplus_acc_strided_views(cuda):
    """Panels are read as views of the distance matrix (row stride N)."""
    d = torch.from_numpy(_ring_adj("fabric", 200, 3, 3)).to(cuda)
    diag = kernel.fw_tile(d[:64, :64])
    got = kernel.minplus_acc(d[None, :, :64], diag[None],
                             init=d[None, :, :64])
    want = ref.minplus_acc_ref(d[None, :, :64], diag[None], d[None, :, :64])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8, 152, 256])
def test_fw_tile_bitwise(cuda, dtype, t):
    rng = np.random.default_rng(t)
    m = rng.uniform(1, 100, (t, t)).astype(np.float32)
    m = np.triu(m, 1) + np.triu(m, 1).T
    x = torch.from_numpy(m).to(cuda, dtype)
    assert torch.equal(kernel.fw_tile(x), ref.fw_tile_ref(x))


@pytest.mark.parametrize("symmetric", [False, True])
def test_apsp_tiled_bitwise(cuda, symmetric):
    adj = torch.from_numpy(_ring_adj("uniform", 300, 1, 3)).to(cuda)
    tile = ops.default_tile(300)
    want = ref.apsp_tiled_ref(ops._pad_to(adj, tile, ops.INF), tile,
                              symmetric=symmetric)[:300, :300]
    assert torch.equal(ops.apsp_tiled(adj, symmetric=symmetric), want)


@pytest.mark.parametrize("method", ["squaring", "tiled"])
def test_engine_on_cuda_bit_equal_cpu(cuda, method):
    rng = np.random.default_rng(7)
    w = make_latency("fabric", 300, seed=7)
    genomes = np.stack([[rng.permutation(300) for _ in range(2)]
                        for _ in range(3)])
    want = batcheval.diameters_of_rings(w, genomes, method=method,
                                        device="cpu")
    got = batcheval.diameters_of_rings(w, genomes, method=method)
    assert batcheval.last_eval_report()["device"].startswith("cuda")
    assert np.array_equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        kernel.minplus_acc(a, a.double())
    with pytest.raises(ValueError, match="unit stride"):
        kernel.minplus_acc(a, a.transpose(1, 2))
    with pytest.raises(ValueError, match="T <= 256"):
        kernel.fw_tile(torch.zeros(264, 264, device=cuda))
