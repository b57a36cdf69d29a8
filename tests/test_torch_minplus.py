"""The port's min-plus layer against the JAX package's: the torch twins and
the blocked Floyd-Warshall schedule bit-equal to ``repro.kernels.minplus``
(its jnp twins and its Pallas kernels in interpret mode) on the CPU.  The
CUDA kernels are held to these twins in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from repro.core.diameter import adjacency_from_rings as j_adjacency
from repro.core.topology import make_latency
from repro.kernels.minplus import ops as jops
from repro.kernels.minplus.kernel import _fw_diag_kernel
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


def _fw_diag_interpret(x: np.ndarray) -> np.ndarray:
    """The reference's Pallas diagonal-tile kernel, alone, in interpret
    mode (the whole tile is its one block)."""
    call = pl.pallas_call(
        _fw_diag_kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))
    return np.asarray(call(jnp.asarray(x)))


@pytest.mark.parametrize("t", [1, 7, 8, 24, 31, 33, 152, 200])
def test_fw_tile_twin_matches_reference(t):
    """The plain version the card holds K2 to, against the reference's
    twin and its Pallas kernel, at the tile sizes K2 is tested at on the
    card: asymmetric, with padding rows and columns (ops.INF) and a
    disconnected node (inf)."""
    rng = np.random.default_rng(5 + t)
    x = rng.uniform(1, 50, (t, t)).astype(np.float32)   # asymmetric
    if t > 4:
        x[t - 2:, :] = ops.INF
        x[:, t - 2:] = ops.INF
        x[1, :] = np.inf
        x[:, 1] = np.inf
        np.fill_diagonal(x, 0.0)
    want = np.asarray(jref.fw_tile_ref(jnp.asarray(x)))
    assert np.array_equal(_fw_diag_interpret(x), want)
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


@pytest.mark.parametrize("variant", kernel.FW_TILE_VARIANTS)
def test_fw_tile_every_variant_takes_the_twin_on_cpu(variant):
    """Each (cluster size, pivots per barrier) K2 is built for is a valid
    argument, the one the path uses among them; on the CPU each takes the
    twin."""
    assert (kernel.FW_TILE_CLUSTER, kernel.FW_TILE_PIVOTS) in \
        kernel.FW_TILE_VARIANTS
    cluster, pivots = variant
    x = _t(np.random.default_rng(cluster * pivots).uniform(1, 9, (12, 12))
           .astype(np.float32))
    assert torch.equal(kernel.fw_tile_variant(x, cluster, pivots),
                       ref.fw_tile_ref(x))
    with pytest.raises(ValueError, match="built for"):
        kernel.fw_tile_variant(x, cluster + 1, pivots)
    with pytest.raises(ValueError, match="built for"):
        kernel.fw_tile_variant(x, cluster, 3)


# --- K1's tile choice and its plain version at the ragged sizes ---------

@pytest.mark.parametrize("shape,want", [
    ((1, 4096, 256, 4096), (128, 1)),    # outer update of the tiled APSP
    ((1, 256, 256, 4096), (64, 1)),      # its row panel
    ((1, 4096, 256, 256), (64, 1)),      # its column panel
    ((4, 256, 256, 256), (64, 4)),       # adapt's squaring step
    ((1, 256, 256, 256), (64, 8)),       # the unbatched N=256 step
])
def test_minplus_variant_at_the_path_shapes(shape, want):
    assert kernel.variant(*shape) == want
    assert want in kernel.MINPLUS_VARIANTS


def test_minplus_variant_at_the_edges_of_its_rules():
    sms = kernel.SMS
    # the 128 x 128 tile from exactly two blocks per SM on
    assert kernel.variant(2 * sms, 128, 256, 128) == (128, 1)
    assert kernel.variant(2 * sms - 1, 128, 256, 128)[0] == 64
    assert kernel.variant(1, 128 * 2 * sms, 256, 1) == (128, 1)
    # 64 x 64 tiles that give a block per SM take no split
    assert kernel.variant(sms, 64, 256, 64) == (64, 1)
    assert kernel.variant(sms - 1, 64, 256, 64) == (64, 2)
    assert kernel.variant(sms // 4, 64, 256, 64) == (64, 4)
    assert kernel.variant(sms // 4 - 1, 64, 256, 64) == (64, 8)
    # each chunk keeps at least two slices of 16: K <= 48 is not split
    for k in (1, 16, 17, 32, 48):
        assert kernel.variant(1, 64, k, 64) == (64, 1)
    assert kernel.variant(1, 64, 64, 64) == (64, 2)
    # at most 8 chunks, and the count is the launch's (none empty)
    assert kernel.variant(1, 1, 4096, 1) == (64, 8)
    assert kernel.variant(1, 64, 80, 64) == (64, 2)       # 5 slices: 3 + 2
    for k in range(1, 600, 7):
        tile, splits = kernel.variant(1, 64, k, 64)
        slices = -(-k // kernel.MINPLUS_BK)
        per = -(-slices // splits)
        assert per * (splits - 1) < slices and (splits == 1 or per >= 2)


@pytest.mark.parametrize("choice", kernel.MINPLUS_VARIANTS)
def test_every_minplus_variant_takes_the_twin_on_cpu(choice):
    rng = np.random.default_rng(choice[0] + choice[1])
    a = _t(rng.uniform(-5, 10, (2, 9, 40)).astype(np.float32))
    b = _t(rng.uniform(-5, 10, (2, 40, 6)).astype(np.float32))
    assert torch.equal(kernel.minplus_acc(a, b, choice=choice),
                       ref.minplus_acc_ref(a, b))
    with pytest.raises(ValueError, match="built for"):
        kernel.minplus_acc(a, b, choice=(choice[0], 3))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (7, 63, 65), (63, 65, 7),
                                   (127, 129, 255), (129, 255, 127),
                                   (255, 7, 257), (257, 257, 1),
                                   (65, 127, 129), (64, 16, 64),
                                   (128, 17, 128), (129, 33, 257),
                                   (1, 48, 129)])
def test_minplus_acc_twin_at_ragged_sizes_matches_reference(m, k, n):
    """The plain version the card holds K1 to, against the JAX package's
    twin at M, N, K below and around K1's tiles (64, 128) and slices (16):
    batch 2, negative operands, a row of A and a column of B at +inf."""
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    a = rng.uniform(-20, 50, (2, m, k)).astype(np.float32)
    b = rng.uniform(-20, 50, (2, k, n)).astype(np.float32)
    c = rng.uniform(-20, 50, (2, m, n)).astype(np.float32)
    a[1, m // 2, :] = np.inf
    b[0, :, n // 2] = np.inf
    want = np.asarray(jref.minplus_batched_ref(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(ref.minplus_acc_ref(_t(a), _t(b)).numpy(), want)
    assert np.array_equal(ref.minplus_acc_ref(_t(a), _t(b), _t(c)).numpy(),
                          np.minimum(c, want))
