"""The int8 ring all-reduce of ``repro_torch.train.collectives`` against the
JAX package's, bit for bit, on the CPU.

The port runs in 8 gloo ranks spawned once for the module (a ``FileStore``
under ``tmp_path``); rings of n = 2, 3 and 8 ranks are groups of that
world.  The reference runs once, in a subprocess with 8 forced host
devices, as ``shard_map`` over an n-device mesh of the same numpy inputs
(``tests/test_collectives.py``'s pattern) under ``jit``, as training runs
it, written to an ``.npz``.  The arithmetic is the reference's op for op
as XLA compiles it (quantize, ``ppermute``, one fused dequantize-add a hop,
one quantization a finished chunk), so outputs and residuals are compared
bitwise, and every rank's reduced output equals every other's.
"""
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from conftest import subproc_env

from repro_torch import distributed as D
from repro_torch.train import collectives as C

SIZES = (2, 3, 8)
LENGTH = 1003                     # not a multiple of 2, 3 or 8: the pad path
BF16_LEN = 37


def _inputs(n: int):
    """Per-rank rows: x (n, LENGTH) fp32, a bf16 leaf's values (n, BF16_LEN)
    as fp32 before the cast, and error feedback (n, LENGTH)."""
    rng = np.random.default_rng(100 + n)
    x = (rng.normal(size=(n, LENGTH)) * 3.0).astype(np.float32)
    b = (rng.normal(size=(n, BF16_LEN)) * 0.5).astype(np.float32)
    e = (rng.normal(size=(n, LENGTH)) * 1e-3).astype(np.float32)
    return x, b, e


JAX_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.train.collectives import ring_allreduce, compressed_grad_allreduce
sys.path.insert(0, "tests")
from test_torch_collectives import _inputs, SIZES

out = {}
for n in (1,) + SIZES:
    mesh = make_mesh((n,), ("data",), devices=jax.devices()[:n])
    x, b, e = _inputs(n)
    ring = jax.jit(shard_map(lambda xl: ring_allreduce(xl[0], "data")[None],
                             mesh=mesh, in_specs=P("data", None),
                             out_specs=P("data", None), check_vma=False))
    out[f"ring{n}"] = np.asarray(ring(jnp.asarray(x)))

    def body(xl, bl, el):
        g = {"w": xl[0], "b": bl[0]}
        mean, err = compressed_grad_allreduce(
            g, "data", {"w": el[0], "b": jnp.zeros_like(bl[0], jnp.float32)})
        return mean["w"][None], mean["b"][None], err["w"][None], err["b"][None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data", None),) * 3,
                           out_specs=(P("data", None),) * 4,
                           check_vma=False))
    mw, mb, ew, eb = fn(jnp.asarray(x), jnp.asarray(b, jnp.bfloat16),
                        jnp.asarray(e))
    for k, v in dict(mw=mw, mb=mb, ew=ew, eb=eb).items():
        out[f"{k}{n}"] = np.asarray(v).astype(np.float32)
np.savez(sys.argv[1], **out)
print("OK")
"""


def _rank_results(rank, world):
    """One rank's outputs for every ring size it belongs to."""
    out = {}
    for n in SIZES:
        g = D.new_group(range(n))           # every rank makes every group
        if g.index < 0:
            continue
        x, b, e = _inputs(n)
        xi = torch.from_numpy(x[g.index])
        out[f"ring{n}"] = C.ring_allreduce(xi, g).numpy()
        grads = {"w": xi, "b": torch.from_numpy(b[g.index]).bfloat16()}
        fb = {"w": torch.from_numpy(e[g.index]),
              "b": torch.zeros(BF16_LEN, dtype=torch.float32)}
        mean, err = C.compressed_grad_allreduce(grads, g, fb)
        out[f"mw{n}"] = mean["w"].numpy()
        out[f"mb{n}"] = mean["b"].float().numpy()
        out[f"ew{n}"], out[f"eb{n}"] = err["w"].numpy(), err["b"].numpy()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the reference's arrays, the 8 ranks' results), computed once:
    the JAX subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("collectives")
    ref = tmp / "ref.npz"
    proc = subprocess.Popen([sys.executable, "-c", JAX_CODE, str(ref)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=subproc_env(), cwd=".")
    try:
        ranks = D.spawn_ranks(_rank_results, 8, timeout=120,
                              workdir=str(tmp))
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "OK" in stdout, stderr[-3000:]
    return dict(np.load(ref)), ranks


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000), st.floats(0.01, 1000.0))
def test_quantize_error_bound(seed, scale):
    """Property (the reference's): |x - dequant(quant(x))| <= max|x|/254."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(0, 1, 64) * scale).astype(np.float32))
    q, s = C._quantize(x)
    err = (x - q.float() * s).abs().max()
    assert float(err) <= float(x.abs().max()) / 254.0 + 1e-6


def test_quantize_is_bitwise_the_reference():
    """Against the reference compiled, as it runs inside the ring."""
    import jax
    import jax.numpy as jnp

    from repro.train.collectives import _quantize

    jquantize = jax.jit(_quantize)

    rng = np.random.default_rng(7)
    for i in range(40):
        x = (rng.normal(size=4099) * 10.0 ** rng.uniform(-3, 3)).astype(
            np.float32)
        if i == 0:
            x[:] = 0.0                       # the 1e-12 floor of the scale
        q, s = C._quantize(torch.from_numpy(x))
        jq, js = jquantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s) == np.float32(js)


def _round_once(a, b, c) -> np.float32:
    """fp32 ``a * b + c`` rounded once from the exact rational value, ties
    to even: what a fused multiply-add gives."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(np.array(v).view(np.int32)) & 1))


# (a, b, c) whose exact a * b is an fp32 tie and whose c is too small for
# the fp64 sum to keep: one rounding goes by c's sign, two go to even
TIES = [
    (1 + 2 ** -12, np.float32(1 + 2 ** -12), 2 ** -60),   # up, from even
    (1 + 2 ** -12, np.float32(1 + 2 ** -12), -2 ** -60),  # down, to even
    (1 + 2 ** -23, np.float32(3), -2 ** -60),             # down, from even
    (1 + 2 ** -23, np.float32(3), 2 ** -60),              # up, to even
    (1 + 2 ** -23, np.int8(-3), 2 ** -60),    # an int8 code, as dequantized
]


@pytest.mark.parametrize("a,b,c", TIES)
def test_fma_rounds_a_planted_tie_once(a, b, c):
    """At an fp32 tie of the product that the fp64 sum rounds onto, ``_fma``
    is the fused multiply-add, as the reference compiled computes it."""
    import jax
    import jax.numpy as jnp

    a, c = np.float32(a), np.float32(c)
    p = np.float64(a) * np.float64(b)
    assert p + np.float64(c) == p                 # the fp64 sum drops c
    assert np.float32(np.nextafter(p, np.inf)) != \
        np.float32(np.nextafter(p, -np.inf))      # p is an fp32 tie
    want = _round_once(a, b, c)
    got = C._fma(torch.from_numpy(np.array([a])),
                 torch.from_numpy(np.array([b])),
                 torch.from_numpy(np.array([c])))
    assert got.dtype == torch.float32 and got.item() == want
    jfma = jax.jit(lambda x, y, z: x * y.astype(jnp.float32) + z)
    assert np.float32(jfma(jnp.asarray(a), jnp.asarray(b),
                           jnp.asarray(c))) == want


FINITE32 = st.floats(-2.0 ** 50, 2.0 ** 50, width=32)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(FINITE32, FINITE32, FINITE32), min_size=1,
                max_size=8))
def test_fma_is_the_exactly_rounded_sum(triples):
    a, b, c = (np.asarray(v, np.float32) for v in zip(*triples))
    got = C._fma(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c)).numpy()
    want = [_round_once(*t) for t in zip(a, b, c)]
    assert got.tolist() == [float(w) for w in want]


def test_fma_slices_as_it_runs_whole(monkeypatch):
    """Over ``_FMA_SLICE`` elements ``_fma`` works a slice at a time, with a
    scalar or an elementwise ``b``, and gives the whole call's bits."""
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
               for _ in range(3))
    s = torch.tensor(np.float32(0.37))
    whole = C._fma(a, b, c), C._fma(a, s, c)
    monkeypatch.setattr(C, "_FMA_SLICE", 4)
    assert torch.equal(C._fma(a, b, c), whole[0])
    assert torch.equal(C._fma(a, s, c), whole[1])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("what", ["ring", "mw", "mb", "ew", "eb"])
def test_ring_allreduce_is_bitwise_the_reference(results, n, what):
    """``ring_allreduce`` (ring), and ``compressed_grad_allreduce``'s means
    (fp32 leaf mw, bf16 leaf mb) and residuals (ew, eb) with error feedback,
    on every rank of an n-rank ring."""
    ref, ranks = results
    got = np.stack([r[f"{what}{n}"] for r in ranks[:n]])
    assert np.array_equal(got, ref[f"{what}{n}"])
    if what[0] != "e":                      # residuals are each rank's own
        assert all(np.array_equal(g, got[0]) for g in got)


def test_one_rank_is_the_reference_one_device_result(results):
    """With no process group the ring is one rank: it still quantizes once,
    as the reference's one-device ring does."""
    ref, _ = results
    x, b, e = _inputs(1)
    got = C.ring_allreduce(torch.from_numpy(x[0]))
    assert np.array_equal(got.numpy(), ref["ring1"][0])
    mean, err = C.compressed_grad_allreduce(
        {"w": torch.from_numpy(x[0]),
         "b": torch.from_numpy(b[0]).bfloat16()},
        None, {"w": torch.from_numpy(e[0]),
               "b": torch.zeros(BF16_LEN, dtype=torch.float32)})
    assert np.array_equal(mean["w"].numpy(), ref["mw1"][0])
    assert np.array_equal(mean["b"].float().numpy(), ref["mb1"][0])
    assert np.array_equal(err["w"].numpy(), ref["ew1"][0])
    assert np.array_equal(err["b"].numpy(), ref["eb1"][0])


@pytest.mark.parametrize("n", SIZES)
def test_ring_sum_is_within_the_quantization_bound(results, n):
    """Every rank's sum against the fp64 sum, within
    ``ring_allreduce_bound`` (n - 1 quantized hops and the final
    quantization of each chunk, derived in its docstring), and the bound
    not vacuous: under 5% of the sum's magnitude."""
    _, ranks = results
    x, _, _ = _inputs(n)
    exact = x.astype(np.float64).sum(0)
    bound = C.ring_allreduce_bound([torch.from_numpy(r) for r in x]).numpy()
    for r in ranks[:n]:
        assert np.all(np.abs(r[f"ring{n}"] - exact) <= bound)
    assert bound.max() < 0.05 * np.abs(exact).max()
