"""The port's min-plus layer against the JAX package's: the torch twins and
the blocked Floyd-Warshall schedule bit-equal to ``repro.kernels.minplus``
(its jnp twins and its Pallas kernels in interpret mode) on the CPU.  The
CUDA kernels are held to these twins in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.diameter import adjacency_from_rings as j_adjacency
from repro.core.topology import make_latency
from repro.kernels.minplus import ops as jops
from repro.kernels.minplus import ref as jref
from repro_torch.kernels.minplus import kernel, ops, ref


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ring_adj(n, seed, k_rings=2):
    rng = np.random.default_rng(seed)
    w = make_latency("uniform", n, seed=seed)
    return j_adjacency(w, [rng.permutation(n) for _ in range(k_rings)])


# --- twins vs the reference oracles ----------------------------------------

@pytest.mark.parametrize("shape_a,shape_b", [((3, 20, 33), (3, 33, 17)),
                                             ((1, 5, 130), (1, 130, 7))])
def test_batched_twins_bit_equal_reference(shape_a, shape_b):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 10, shape_a).astype(np.float32)
    b = rng.uniform(0, 10, shape_b).astype(np.float32)
    c = rng.uniform(0, 10, shape_a[:2] + shape_b[2:]).astype(np.float32)
    want = np.asarray(jref.minplus_batched_ref(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(ref.minplus_batched_ref(_t(a), _t(b)).numpy(), want)
    assert np.array_equal(ref.minplus_acc_ref(_t(a), _t(b)).numpy(), want)
    assert np.array_equal(ref.minplus_acc_ref(_t(a), _t(b), _t(c)).numpy(),
                          np.minimum(c, want))
    # unbatched twin and entry point, against the reference's Pallas kernel
    ka = jnp.asarray(a[0])
    kb = jnp.asarray(b[0])
    want2 = np.asarray(jops.minplus(ka, kb, interpret=True))
    assert np.array_equal(ref.minplus_ref(_t(a[0]), _t(b[0])).numpy(), want2)
    assert np.array_equal(ops.minplus(_t(a[0]), _t(b[0])).numpy(), want2)
    assert np.array_equal(ops.minplus_batched(_t(a), _t(b)).numpy(), want)


def test_minplus_batched_matches_reference_kernel_interpret():
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 10, (2, 45, 70)).astype(np.float32)
    b = rng.uniform(0, 10, (2, 70, 31)).astype(np.float32)
    want = np.asarray(jops.minplus_batched(jnp.asarray(a), jnp.asarray(b),
                                           force_kernel=True))
    assert np.array_equal(ops.minplus_batched(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("n", [1, 7, 20, 33, 100, 128, 129, 300, 1000, 4096])
def test_block_and_tile_rules_match_reference(n):
    assert ops.default_tile(n) == jops.default_tile(n)
    assert ops.default_tile(300) == 152


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n,tile", [(24, 8), (37, 16), (64, 16)])
def test_apsp_tiled_bit_equal_reference(n, tile, symmetric):
    adj = _ring_adj(n, seed=n)
    want = np.asarray(jops.apsp_tiled(jnp.asarray(adj), tile=tile,
                                      symmetric=symmetric))
    kern = np.asarray(jops.apsp_tiled(jnp.asarray(adj), tile=tile,
                                      force_kernel=True, interpret=True))
    assert np.array_equal(want, kern)
    got = ops.apsp_tiled(_t(adj), tile=tile, symmetric=symmetric).numpy()
    assert np.array_equal(got, want)
    padded = ops._pad_to(_t(adj), tile, ops.INF)
    twin = ref.apsp_tiled_ref(padded, tile, symmetric=symmetric)[:n, :n]
    assert np.array_equal(twin.numpy(), want)


@pytest.mark.parametrize("n,tile", [(37, 16), (64, 16)])
def test_apsp_tiled_bf16_within_reference_tolerance(n, tile):
    """bf16 keeps ~3 decimal digits; the reference holds its bf16 diameters
    to 5% of float32 (``DEFAULT_EXACT_RTOL``).  The port is held to the
    reference's bf16 result at that tolerance -- and, on the CPU, is in
    fact bitwise equal (both add in fp32 and round each sum to bf16)."""
    rng = np.random.default_rng(n)
    w = make_latency("gaussian", n, seed=n)
    adj = j_adjacency(w, [rng.permutation(n) for _ in range(2)])
    want = np.asarray(jops.apsp_tiled(jnp.asarray(adj).astype(jnp.bfloat16),
                                      tile=tile).astype(jnp.float32))
    got = ops.apsp_tiled(_t(adj).bfloat16(), tile=tile).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.05)
    assert np.array_equal(got, want)
    exact = np.asarray(jops.apsp_tiled(jnp.asarray(adj), tile=tile))
    np.testing.assert_allclose(got, exact, rtol=0.05)


def test_fw_tile_twin_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.uniform(1, 50, (24, 24)).astype(np.float32)   # asymmetric
    want = np.asarray(jref.fw_tile_ref(jnp.asarray(x)))
    assert np.array_equal(ref.fw_tile_ref(_t(x)).numpy(), want)
    sym = np.minimum(x, x.T)
    assert np.array_equal(
        ref.fw_tile_ref(_t(sym), symmetric=True).numpy(),
        np.asarray(jref.fw_tile_ref(jnp.asarray(sym), symmetric=True)))


# --- wrappers on the CPU --------------------------------------------------

def test_wrappers_take_the_twin_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(8)
    a = _t(rng.uniform(0, 10, (2, 9, 11)).astype(np.float32))
    b = _t(rng.uniform(0, 10, (2, 11, 6)).astype(np.float32))
    c = _t(rng.uniform(0, 10, (2, 9, 6)).astype(np.float32))
    kernel.reset_launches()
    assert torch.equal(kernel.minplus_acc(a, b, c),
                       ref.minplus_acc_ref(a, b, c))
    out = c.clone()
    assert kernel.minplus_acc(a, b, init=out, out=out) is out
    assert torch.equal(out, ref.minplus_acc_ref(a, b, c))
    x = _t(rng.uniform(1, 9, (16, 16)).astype(np.float32))
    assert torch.equal(kernel.fw_tile(x), ref.fw_tile_ref(x))
    assert kernel.launches == {"minplus_acc": 0, "fw_tile": 0}


def test_wrapper_checks():
    a = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="alias"):
        kernel.minplus_acc(a, torch.zeros(1, 4, 4), out=a)
    with pytest.raises(ValueError, match="shapes"):
        kernel.minplus_acc(a, torch.zeros(1, 5, 4))
    with pytest.raises(ValueError, match="init"):
        kernel.minplus_acc(a, a.clone(), init=torch.zeros(1, 4, 5))
    with pytest.raises(ValueError, match="square"):
        kernel.fw_tile(torch.zeros(3, 4))
