"""The port's sharding rules and spec functions (``repro_torch.models.
sharding``, ``repro_torch.launch.shardings``) against the JAX package's,
on the CPU, with no devices: the reference's functions run on
``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` of its inits, the
port's on a ``launch.mesh.Mesh`` plan over shapes from ``device="meta"``.

For every leaf of all 10 configs at full size, on the meshes (16, 16),
(2, 16, 16) (data axes ("pod", "data")), (1, 4) and (2, 2): ``param_specs``
in its three modes, ``zero3_param_specs``, ``state_specs`` with ZeRO on
and off, ``cache_specs`` at two decode shapes and ``batch_specs`` give the
same spec.  Also: the rule tables and ``_NAME_RULES`` equal the
reference's, ``fix_spec`` equals ``shard``'s divisibility fix, every
rank's ``local_slice`` block tiles the whole once (``gather_leaf``, its
inverse, runs in the 4-rank files), and the forward modes a model axis
does not cover raise, naming 13f.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.launch import shardings as JS
from repro.models import model as JM
from repro.models import sharding as JSH
from repro.train import train_step as JT

from repro_torch.configs import get_arch
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.models import sharding as SH
from repro_torch.train import train_step as TT
from repro_torch.train.optimizer import AdamWState

NAMES = sorted(JARCHS)
MESHES = {
    "16x16": ((16, 16), ("data", "model"), ("data",)),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data")),
    "1x4": ((1, 4), ("data", "model"), ("data",)),
    "2x2": ((2, 2), ("data", "model"), ("data",)),
}
CACHES = ((128, 32_768), (1, 4_096))


def test_ten_configs():
    assert len(NAMES) == 10


def _meshes(key):
    shape, axes, data = MESHES[key]
    return (AbstractMesh(shape, axes),
            Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes), data)


def _jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def _tflat(tree) -> dict:
    out = {}

    def put(path, s):
        out[S.keystr(path)] = tuple(s)
        return s

    S.tree_map_with_path(put, tree)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(name):
    """(JAX state shapes, port state shapes) of the full-size config."""
    jcfg, tcfg = jget_arch(name), get_arch(name)
    jstate = jax.eval_shape(lambda: JT.init_state(jcfg, jax.random.PRNGKey(0)))
    params = TM.init_params(tcfg, device="meta")
    tstate = TT.TrainState(params, AdamWState(
        torch.zeros((), dtype=torch.int32, device="meta"), params, params))
    return jstate, tstate


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_and_state_specs_equal_the_reference(name, mesh):
    jmesh, tmesh, data = _meshes(mesh)
    jstate, tstate = _shapes(name)
    n = len(jax.tree.leaves(jstate.params))
    for mode in ("tp", "fsdp", "dp"):
        want = _jflat(JS.param_specs(jstate.params, jmesh, mode=mode))
        got = _tflat(S.param_specs(tstate.params, tmesh, mode=mode))
        assert got == want, mode
        assert len(got) == n
    assert _tflat(S.zero3_param_specs(tstate.params, tmesh, data)) == \
        _jflat(JS.zero3_param_specs(jstate.params, jmesh, data))
    for zero in (True, False):
        want = JS.state_specs(jstate, jmesh, data, zero=zero)
        got = S.state_specs(tstate, tmesh, data, zero=zero)
        assert tuple(got.opt.step) == tuple(want.opt.step) == ()
        for part in ("mu", "nu"):
            assert _tflat(getattr(got.opt, part)) == \
                _jflat(getattr(want.opt, part)), (zero, part)
        assert _tflat(got.params) == _jflat(want.params)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_the_reference(name, mesh):
    jmesh, tmesh, data = _meshes(mesh)
    jcfg, tcfg = jget_arch(name), get_arch(name)
    for batch, max_len in CACHES:
        jc = jax.eval_shape(lambda: JM.init_caches(jcfg, batch, max_len))
        tc = TM.init_caches(tcfg, batch, max_len, device="meta")
        want = _jflat(JS.cache_specs(jc, jmesh, batch, data))
        got = _tflat(S.cache_specs(tc, tmesh, batch, data))
        assert got == want, (batch, max_len)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 8, 24, 256])
def test_batch_specs_equal_the_reference(batch, mesh):
    jmesh, tmesh, data = _meshes(mesh)
    shapes = {"tokens": (batch, 4096), "labels": (batch, 4096),
              "vision_embeds": (batch, 16, 5120), "scalar": ()}
    want = _jflat(JS.batch_specs(
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()},
        jmesh, data))
    got = _tflat(S.batch_specs(
        {k: torch.empty(s, device="meta") for k, s in shapes.items()},
        tmesh, data))
    assert got == want


def test_name_rules_and_rule_tables_equal_the_reference():
    assert S._NAME_RULES == JS._NAME_RULES
    for data in (("data",), ("pod", "data")):
        for table in ("default", "fsdp", "dp"):
            ref = getattr(JSH, f"{table}_rules")(data_axes=data)
            port = getattr(SH, f"{table}_rules")(data_axes=data)
            assert {k: SH.P(v)[0] if v is not None else None
                    for k, v in port.rules.items()} == {
                k: JP(v)[0] if v is not None else None
                for k, v in ref.rules.items()}, table
            for logical in (("batch", "seq", "embed"), ("batch", "vocab"),
                            (None, "heads", "ff")):
                assert tuple(port.spec(*logical)) == \
                    tuple(ref.spec(*logical))


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


SHARD_CASES = [
    ((1, 8, 64), ("batch", "seq", "embed")),        # decode: batch of 1
    ((256, 4096, 2048), ("batch", "seq", "embed")),
    ((24, 4096, 1152), ("batch", "seq", "embed")),
    ((8, 4096, 262_144), ("batch", "seq", "vocab")),
    ((8, 100), ("batch", "vocab")),                 # 100 % 16 != 0
    ((16, 4096, 12), ("batch", "seq", "heads")),    # 12 heads < 16
    ((32, 64), ("batch",)),                         # spec shorter than x
]


@pytest.mark.parametrize("mesh_shape", [{"data": 16, "model": 16},
                                        {"pod": 2, "data": 16, "model": 16},
                                        {"data": 2, "model": 2}])
@pytest.mark.parametrize("shape,logical", SHARD_CASES)
def test_fix_spec_is_the_reference_shard_fix(monkeypatch, shape, logical,
                                             mesh_shape):
    """The reference's ``shard`` under rules with a mesh, its constraint
    captured where it would hand it to XLA."""
    data = ("pod", "data") if "pod" in mesh_shape else ("data",)
    seen = []
    monkeypatch.setattr(jax.sharding, "NamedSharding",
                        lambda mesh, spec: seen.append(tuple(spec)))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: x)
    with JSH.use_rules(JSH.default_rules(data, mesh=_FakeMesh(mesh_shape))):
        JSH.shard(jax.ShapeDtypeStruct(shape, jnp.float32), *logical)
    rules = SH.default_rules(data, mesh=_FakeMesh(mesh_shape))
    got = SH.fix_spec(shape, rules.spec(*logical), mesh_shape)
    assert tuple(got) == seen[0]
    x = torch.empty(shape, device="meta")
    with SH.use_rules(rules):
        assert SH.shard(x, *logical) is x
    assert SH.active_rules() is None


def test_partition_spec_normalizes_as_jax_does():
    for parts in [(("data",), None, "model"), (("pod", "data"),), (),
                  (None, None)]:
        assert tuple(SH.P(*parts)) == tuple(JP(*parts))


@pytest.mark.parametrize("spec", [("model", None), (None, "model"),
                                  (("data", "model"), None),
                                  ("data", "model"), (None, None)])
def test_local_slice_blocks_tile_the_whole(spec):
    """Every rank's block, placed at its coordinates, rebuilds the whole
    once (the order ``gather_leaf`` gathers in)."""
    mesh = Mesh(np.arange(8).reshape(2, 4)[[1, 0]], ("data", "model"))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    shape = S.local_shape(tuple(x.shape), spec, mesh)
    seen = torch.zeros_like(x)
    for r in range(8):
        blk = S.local_slice(x, spec, mesh, r)
        assert tuple(blk.shape) == shape
        c = dict(zip(mesh.axis_names, mesh.coords(r)))
        lo = []
        for d, e in enumerate(SH.P(*spec)):
            axes = SH.PartitionSpec.axes_of(e)
            idx = int(np.ravel_multi_index([c[a] for a in axes],
                                           [mesh.shape[a] for a in axes])) \
                if axes else 0
            lo.append(idx * shape[d])
        want = x[lo[0]:lo[0] + shape[0], lo[1]:lo[1] + shape[1]]
        assert torch.equal(blk, want)
        seen[lo[0]:lo[0] + shape[0], lo[1]:lo[1] + shape[1]] += 1
    parts = int(np.prod([mesh.axis_size(S.spec_axes(SH.P(*spec)))])) \
        if S.spec_axes(SH.P(*spec)) else 1
    assert torch.equal(seen, torch.full_like(x, 8 / parts))


INIT_NAMES = ("gemma3-1b", "moonshot-v1-16b-a3b", "pixtral-12b", "zamba2-7b")


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", INIT_NAMES)
def test_init_sharded_state_is_the_whole_draw_cut(name, shape):
    """Every rank's ``init_sharded_state`` (weights cut as they are drawn)
    is its blocks of ``init_state``'s, bitwise, and its moments are zeros
    of their blocks' shapes."""
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_arch(name).smoke()
    mesh = Mesh(np.arange(4).reshape(shape), ("data", "model"))
    specs = TT.state_layout(cfg, mesh)
    whole = TT.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    for rank in range(4):
        got = TT.init_sharded_state(cfg, specs, mesh, rank,
                                    torch.Generator().manual_seed(0),
                                    device="cpu")
        want = S.shard_params(whole, specs, mesh, rank)
        for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
            assert a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(tree_leaves(got.opt.mu) + tree_leaves(got.opt.nu),
                        tree_leaves(want.opt.mu) + tree_leaves(want.opt.nu)):
            assert a.shape == b.shape and not a.any()


def test_init_sharded_state_holds_one_whole_leaf_at_a_time(monkeypatch):
    """When a weight is cut to its block, no earlier weight drawn whole is
    still alive: a rank's peak is one whole leaf beside its blocks."""
    import weakref

    cfg = get_arch("moonshot-v1-16b-a3b").smoke()
    mesh = _tp_mesh()
    specs = TT.state_layout(cfg, mesh)
    cut, orig = [], S.local_slice

    def watched(x, spec, mesh_, rank):
        assert all(ref() is None for ref in cut), "a whole leaf outlived " \
            "its cut"
        block = orig(x, spec, mesh_, rank)
        if block is not x:
            cut.append(weakref.ref(x))
        return block

    monkeypatch.setattr(S, "local_slice", watched)
    TT.init_sharded_state(cfg, specs, mesh, 0,
                          torch.Generator().manual_seed(0), device="cpu")
    assert len(cut) >= 8       # the experts, attention and vocab tables


@pytest.mark.parametrize("micro", [1, 2, 4])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_local_batch_gives_each_rank_its_part_of_every_microbatch(shape,
                                                                  micro):
    """Rank r's rows are, microbatch by microbatch of the global batch
    (rows i B/m ... (i+1) B/m), its data coordinate's share of them, or
    all of them where a microbatch does not divide by the data axis."""
    mesh = Mesh(np.arange(4).reshape(shape)[::-1], ("data", "model"))
    rows = 8
    batch = {"tokens": torch.arange(rows * 3).reshape(rows, 3),
             "labels": torch.arange(rows)}
    for rank in range(4):
        got = S.local_batch(batch, mesh, rank, microbatches=micro)
        n, parts = rows // micro, shape[0]
        d = mesh.coords(rank)[0]
        want = []
        for i in range(micro):
            lo = i * n
            if n % parts == 0:
                want += range(lo + d * n // parts, lo + (d + 1) * n // parts)
            else:
                want += range(lo, lo + n)
        assert torch.equal(got["labels"], torch.tensor(want)), (rank, micro)
        assert torch.equal(got["tokens"], batch["tokens"][want])
    if micro == 1:
        bs = S.batch_specs(batch, mesh)
        for rank in range(4):
            got = S.local_batch(batch, mesh, rank)
            for k, v in batch.items():
                assert torch.equal(got[k], S.local_slice(v, bs[k], mesh,
                                                         rank))


# --- what a model axis does not cover raises --------------------------------

def _tp_mesh():
    return Mesh(np.arange(4).reshape(1, 4), ("data", "model"))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_prefill_and_decode_over_a_model_axis_raise_13f(mode):
    cfg = get_arch("gemma3-1b").smoke()
    params = TM.init_params(cfg, device="cpu")
    caches = TM.init_caches(cfg, 1, 16, device="cpu")
    toks = torch.zeros((1, 1 if mode == "decode" else 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="13f"):
        TM.forward(cfg, params, toks, mode=mode, caches=caches,
                   pos=8 if mode == "decode" else None, mesh=_tp_mesh())


@pytest.mark.parametrize("mode", ["train", "train_hidden", "prefill"])
@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_families_over_a_model_axis_raise_13f(name, mode):
    cfg = get_arch(name).smoke()
    params = TM.init_params(cfg, device="cpu")
    caches = None if mode != "prefill" else TM.init_caches(cfg, 1, 128,
                                                           device="cpu")
    with pytest.raises(NotImplementedError, match="13f"):
        TM.forward(cfg, params, torch.zeros((1, 128), dtype=torch.long),
                   mode=mode, caches=caches, mesh=_tp_mesh())


def test_meta_caches_have_the_cpu_shapes():
    cfg = get_arch("zamba2-7b").smoke()
    meta = TM.init_caches(cfg, 2, 64, device="meta")
    cpu = TM.init_caches(cfg, 2, 64, device="cpu")
    assert _tflat(S.tree_map_with_path(lambda p, t: SH.P(*t.shape), meta)) \
        == _tflat(S.tree_map_with_path(lambda p, t: SH.P(*t.shape), cpu))
