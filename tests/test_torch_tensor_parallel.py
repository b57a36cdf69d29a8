"""Tensor-parallel training (``repro_torch`` over a ("data", "model") mesh)
against the JAX package's mesh step, on the CPU: dense configs here
(gemma3-1b: tied head, one KV head split inside the head at a 4-way axis;
qwen1.5-4b: qkv bias; :data:`VARIANTS` of both whose query heads do not
split into whole heads a rank; gemma3-1b with 2 microbatches a step).
``test_torch_tp_frontend.py`` (pixtral-12b,
musicgen-large) and ``test_torch_expert_parallel.py`` (moonshot-v1-16b-a3b)
use the machinery of this file.

The reference is ``repro.train.train_step`` under ``jit`` with the
``state_specs`` / ``batch_specs`` shardings under ``default_rules``, on
``make_mesh((1, 4))`` and ``((2, 2))`` of 4 forced host devices, 2 steps
with remat (the reference's own launcher's step).  It runs once a file, in
a subprocess, and writes each config's initial parameters first, so the
port's 4 gloo ranks start while it compiles.  The port's ranks carry those
parameters across (``convert.params_from_jax``), keep their blocks
(``launch.shardings.shard_params``) and train on their data shards
(``batch_specs`` / ``local_slice``).

Tolerances, with their reasons:
  * loss, ce, aux and grad norm: rel 1e-5 (the same arithmetic, summed
    in another order over ranks);
  * the first moment after step 1 (0.1 x the clipped gradient) gathered
    back: every leaf within 1e-4 x its max |want|;
  * parameters gathered back after each step: within 1e-4 x max(1,
    max |want|), the repo's parity tolerance for AdamW trajectories
    (``test_torch_train.py``): a step moves an element by lr x m /
    sqrt(v), so an element whose gradient is within rounding of zero
    moves by a part of lr when the gradient's last bits do (lr 1e-3
    here);
  * leaves the specs leave whole (norms, routers) equal on every rank,
    bitwise, after each step; the ZeRO step bitwise the unsliced one.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import subproc_env

from repro_torch import distributed as D
from repro_torch.launch.mesh import Mesh

SEQ, BATCH, LR, STEPS = 32, 4, 1e-3, 2
MESHES = ((1, 4), (2, 2))
RANKS = 4
# smoke configs whose query heads do not split into whole heads over a
# 4-way model axis (the production mesh's 16-way axis does this to
# qwen1.5-4b's 20 heads and llama4-maverick's 40), run on (1, 4) only:
# 6 heads of 16 (wq / wo split into 1.5 heads a rank: q gathered, every
# rank runs all heads and keeps its 24 columns for its rows of wo);
# 12 heads over 6 KV heads (3 local heads a rank reading KV heads 0 0 1,
# 1 2 2, ...: the groups straddle the ranks); 3 heads of 6 (wq / wo whole
# on every rank: 18 columns do not divide by 4)
VARIANTS = {
    "qwen1.5-4b-h6kv2": ("qwen1.5-4b", {"n_heads": 6, "n_kv_heads": 2}),
    "gemma3-1b-h12kv6": ("gemma3-1b", {"n_heads": 12, "n_kv_heads": 6}),
    "qwen1.5-4b-h3d6": ("qwen1.5-4b", {"n_heads": 3, "n_kv_heads": 1,
                                       "head_dim": 6}),
}


def config(name):
    """The smoke config of ``name``, or of a :data:`VARIANTS` entry."""
    from repro_torch.configs import get_arch

    base, kw = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(get_arch(base).smoke(), **kw)


def meshes(name):
    return MESHES[:1] if name in VARIANTS else MESHES

JAX_CODE = r'''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch.shardings import batch_specs, state_specs, to_shardings
from repro.models import model as JM
from repro.models.sharding import default_rules, use_rules
from repro.train import train_step as JT
from repro.train.optimizer import AdamWConfig

out_dir, names = sys.argv[1], sys.argv[2].split(",")
SEQ, BATCH, LR, STEPS = (int(sys.argv[3]), int(sys.argv[4]),
                         float(sys.argv[5]), int(sys.argv[6]))
VARIANTS = json.loads(sys.argv[7])
MICRO = [n for n in sys.argv[8].split(",") if n]
MESHES = ((1, 4), (2, 2))


def config(name):
    base, kw = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(get_arch(base).smoke(), **kw)


def meshes(name):
    return MESHES[:1] if name in VARIANTS else MESHES


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def batches(cfg):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, mean_doc_len=SEQ / 2))
    rng = np.random.default_rng(7)
    out = []
    for i in range(STEPS):
        b = dict(data.batch(i))
        if cfg.frontend == "vision":
            b["vision_embeds"] = rng.normal(
                0, 1, (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def save(path, arrays):
    np.savez(path + ".tmp.npz", **arrays)
    os.rename(path + ".tmp.npz", path + ".npz")


def layer_probs(cfg, mesh, params, tokens):
    """Router probabilities of every MoE layer of the mesh forward (the
    reference's moe_apply over the mesh, recorded outside the scan)."""
    seen, orig = [], JM.moe_apply

    def rec(*a, **kw):
        y, pr = orig(*a, **kw)
        seen.append(pr)
        return y, pr

    JM.moe_apply = rec
    try:
        x = jnp.take(params["embed"], tokens, axis=0)
        pos = jnp.arange(tokens.shape[1], dtype=jnp.int32)
        per = JM.pattern_period(cfg)
        for i in range(cfg.n_layers // per):
            for j in range(per):
                lp = jax.tree.map(lambda a: a[i], params["blocks"][f"pos{j}"])
                x, _, _ = JM._attn_mlp_layer(
                    cfg, JM.layer_kind(cfg, j), lp, x, positions=pos,
                    cache=None, cache_pos=None, mesh=mesh,
                    data_axes=("data",), mode="train")
    finally:
        JM.moe_apply = orig
    return seen


states = {}
for name in names:
    cfg = config(name)
    states[name] = JT.init_state(cfg, jax.random.PRNGKey(0))
    save(os.path.join(out_dir, f"p0-{name}"), flat(states[name].params))

for name in names:
    cfg = config(name)
    tc = JT.TrainConfig(optimizer=AdamWConfig(lr=LR, weight_decay=0.1),
                        remat=True)
    bs = batches(cfg)
    out = {f"batch{i}/{k}": v for i, b in enumerate(bs) for k, v in b.items()}
    for shape in meshes(name):
        tag = "x".join(map(str, shape))
        mesh = make_mesh(shape, ("data", "model"))
        rules = default_rules(("data",), mesh=mesh)
        st_shard = to_shardings(state_specs(
            jax.eval_shape(lambda: states[name]), mesh, ("data",)), mesh)
        b_shard = to_shardings(batch_specs(jax.eval_shape(
            lambda: {k: jnp.asarray(v) for k, v in bs[0].items()}), mesh,
            ("data",)), mesh)

        def jit_step(tc):
            def step_fn(s, b):
                with use_rules(rules):
                    return JT.train_step(cfg, tc, s, b, mesh=mesh,
                                         data_axes=("data",))
            return jax.jit(step_fn, in_shardings=(st_shard, b_shard))

        step = jit_step(tc)
        probs_fn = None
        if cfg.family == "moe":
            def pf(p, t):
                with use_rules(rules):
                    return layer_probs(cfg, mesh, p, t)
            probs_fn = jax.jit(pf, in_shardings=(st_shard.params,
                                                 b_shard["tokens"]))
        state = jax.device_put(states[name], st_shard)
        for i, b in enumerate(bs):
            jb = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                b_shard)
            if probs_fn is not None:
                for l, pr in enumerate(probs_fn(state.params, jb["tokens"])):
                    out[f"{tag}/probs{i}/{l}"] = np.asarray(pr)
            state, met = step(state, jb)
            state = jax.device_put(state, st_shard)
            for k, v in met.items():
                out[f"{tag}/{k}{i}"] = np.asarray(v)
            out.update({f"{tag}/p{i}/{k}": v
                        for k, v in flat(state.params).items()})
            if i == 0:
                out.update({f"{tag}/mu0/{k}": v
                            for k, v in flat(state.opt.mu).items()})
        if name in MICRO:
            # one step of 2 microbatches (rows 0, 1 | 2, 3 of the batch),
            # row r's first 8 r labels masked
            mb = dict(bs[0], labels=bs[0]["labels"].copy())
            for r in range(BATCH):
                mb["labels"][r, :8 * r] = -1
            state, met = jit_step(dataclasses.replace(tc, microbatches=2))(
                jax.device_put(states[name], st_shard),
                jax.device_put({k: jnp.asarray(v) for k, v in mb.items()},
                               b_shard))
            out[f"{tag}/micro/loss"] = np.asarray(met["loss"])
            out[f"{tag}/micro/grad_norm"] = np.asarray(met["grad_norm"])
            out.update({f"{tag}/micro/p/{k}": v
                        for k, v in flat(state.params).items()})
    save(os.path.join(out_dir, f"ref-{name}"), out)
print("OK")
'''


def _unflatten(flat: dict, skeleton: dict) -> dict:
    """``{"a/b": leaf}`` as a nested dict with ``skeleton``'s empty dicts."""
    def empty(skel):
        return {k: empty(v) for k, v in skel.items() if isinstance(v, dict)}

    tree = empty(skeleton)
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _load(path, prefix=""):
    with np.load(path) as data:
        return {k[len(prefix):]: data[k] for k in data.files
                if k.startswith(prefix)}


def _start_reference(tmp, names, micro=()):
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(tmp), ",".join(names), str(SEQ),
         str(BATCH), str(LR), str(STEPS), json.dumps(VARIANTS),
         ",".join(micro)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=subproc_env(), cwd=".")


def _wait_for(path, proc, seconds=180):
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        assert proc.poll() is None, proc.communicate()[1][-3000:]
        assert time.monotonic() < deadline, f"no {path}"
        time.sleep(0.1)


class Recorder:
    """Router probabilities of every ``moe.moe_apply`` call, in call order
    (a remat'd block's recomputation included)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.apply, self.seen = moe, moe.moe_apply, []

    def __enter__(self):
        def recording(*a, **kw):
            y, probs = self.apply(*a, **kw)
            self.seen.append(probs.detach().clone())
            return y, probs
        self.moe.moe_apply = recording
        return self.seen

    def __exit__(self, *exc):
        self.moe.moe_apply = self.apply


def _port_run(name, ref_dir, rank, shape, zero=True):
    """One config on one mesh: 2 steps from the reference's initial
    parameters.  Returns this rank's numbers (rank 0 adds the gathered
    trees)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.shardings import (batch_specs, gather_params,
                                              local_shape, local_slice,
                                              shard_params, spec_axes,
                                              tree_map_with_path)
    from repro_torch.models import convert
    from repro_torch.models.convert import flatten
    from repro_torch.models.model import init_params
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             tree_leaves)

    cfg = config(name)
    tc = TT.TrainConfig(optimizer=AdamWConfig(lr=LR, weight_decay=0.1),
                        remat=True)
    p0 = _load(os.path.join(ref_dir, f"p0-{name}.npz"))
    params = convert.params_from_jax(
        _unflatten(p0, init_params(cfg, device="meta")), cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, mean_doc_len=SEQ / 2))
    rng = np.random.default_rng(7)
    batches = []
    for i in range(STEPS):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        if cfg.frontend == "vision":
            b["vision_embeds"] = torch.from_numpy(rng.normal(
                0, 1, (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32))
        batches.append(b)
    mesh = Mesh(np.arange(RANKS).reshape(shape), ("data", "model"))
    specs = TT.state_layout(cfg, mesh, zero=zero)
    state = shard_params(TT.TrainState(params, adamw_init(params)), specs,
                         mesh, rank)
    want_mu = sum(int(np.prod(local_shape(tuple(t.shape), s, mesh)))
                  for t, s in zip(tree_leaves(params),
                                  tree_leaves(specs.opt.mu)))
    out = {"mu_elements": sum(t.numel() for t in tree_leaves(state.opt.mu)),
           "mu_want": want_mu,
           "whole_elements": sum(t.numel() for t in tree_leaves(params)),
           "steps": [], "probs": []}
    whole_specs = flatten(tree_map_with_path(
        lambda path, s: not any(mesh.shape[a] > 1 for a in spec_axes(s)),
        specs.params))
    for i, b in enumerate(batches):
        bs = batch_specs(b, mesh)
        local = {k: local_slice(v, bs[k], mesh, rank) for k, v in b.items()}
        with Recorder() as seen:
            state, met = TT.train_step(cfg, tc, state, local, mesh=mesh,
                                       specs=specs)
        rec = {k: float(v) for k, v in met.items()}
        rec["whole"] = {k: v.numpy().tobytes()
                        for k, v in flatten(state.params).items()
                        if whole_specs[k]}
        gathered = gather_params(state.params, specs.params, mesh)
        if i == 0:
            mu = gather_params(state.opt.mu, specs.opt.mu, mesh)
        if rank == 0:
            rec["p"] = {k: v.numpy() for k, v in flatten(gathered).items()}
            if i == 0:
                rec["mu"] = {k: v.numpy() for k, v in flatten(mu).items()}
            out["probs"].append([p.numpy() for p in
                                 seen[:cfg.n_layers if cfg.n_experts else 0]])
        out["steps"].append(rec)
    return out


def _micro_run(name, ref_dir, rank, shape):
    """One step with 2 microbatches on ``shape``, each rank holding its
    part of both microbatches of the global batch (``local_batch``), and
    the one-device step with 2 microbatches on the whole batch (row r's
    first 8 r labels masked in both): (loss,
    grad norm, parameters gathered back) of each, as numpy on rank 0."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.shardings import (gather_params, local_batch,
                                              shard_params)
    from repro_torch.models import convert
    from repro_torch.models.convert import flatten
    from repro_torch.models.model import init_params
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = config(name)
    tc = TT.TrainConfig(optimizer=AdamWConfig(lr=LR, weight_decay=0.1),
                        remat=True, microbatches=2)
    params = convert.params_from_jax(_unflatten(
        _load(os.path.join(ref_dir, f"p0-{name}.npz")),
        init_params(cfg, device="meta")), cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, mean_doc_len=SEQ / 2))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    for r in range(BATCH):
        # rows of other token counts: microbatches' means differ by rows
        batch["labels"][r, :8 * r] = -1
    mesh = Mesh(np.arange(RANKS).reshape(shape), ("data", "model"))
    specs = TT.state_layout(cfg, mesh)
    state = shard_params(TT.TrainState(params, adamw_init(params)), specs,
                         mesh, rank)
    st, met = TT.train_step(cfg, tc, state, local_batch(
        batch, mesh, rank, microbatches=2), mesh=mesh, specs=specs)
    whole = flatten(gather_params(st.params, specs.params, mesh))
    one, met1 = TT.train_step(cfg, tc, TT.TrainState(params,
                                                     adamw_init(params)),
                              batch)
    if rank:
        return None
    return ((float(met["loss"]), float(met["grad_norm"]),
             {k: v.numpy() for k, v in whole.items()}),
            (float(met1["loss"]), float(met1["grad_norm"]),
             {k: v.numpy() for k, v in flatten(one.params).items()}))


def rank_main(rank, world, ref_dir, names, zero_off):
    """Every config on its meshes (and, for ``zero_off``, (2, 2) with
    unsliced moments and both meshes with 2 microbatches)."""
    torch.use_deterministic_algorithms(True)
    out = {}
    for name in names:
        for shape in meshes(name):
            out[(name, shape)] = _port_run(name, ref_dir, rank, shape)
        if name in zero_off:
            out[(name, "nozero")] = _port_run(name, ref_dir, rank, (2, 2),
                                              zero=False)
            for shape in MESHES:
                out[(name, "micro", shape)] = _micro_run(name, ref_dir,
                                                         rank, shape)
    return out


def run_file(tmp, names: tuple, zero_off: tuple = ()):
    """The reference and the port's 4 gloo ranks for ``names`` (a module
    fixture's, once a file), working in ``tmp``: (reference numbers by
    config, rank outputs)."""
    tmp = str(tmp)
    proc = _start_reference(tmp, names, zero_off)
    try:
        for name in names:
            _wait_for(os.path.join(tmp, f"p0-{name}.npz"), proc)
        ranks = D.spawn_ranks(rank_main, RANKS,
                              args=(tmp, names, zero_off), timeout=300,
                              workdir=tmp)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "OK" in stdout, stderr[-3000:]
    ref = {name: _load(os.path.join(tmp, f"ref-{name}.npz"))
           for name in names}
    return ref, ranks


def check_metrics(ref, ranks, name, shape):
    ref, tag = ref[name], "x".join(map(str, shape))
    for i in range(STEPS):
        for key in ("loss", "ce", "aux", "grad_norm", "n_tok"):
            want = float(ref[f"{tag}/{key}{i}"])
            for out in ranks:
                got = out[(name, shape)]["steps"][i][key]
                assert got == pytest.approx(want, rel=1e-5, abs=1e-7), \
                    (name, shape, i, key)


def check_leaves(ref, ranks, name, shape):
    ref, tag = ref[name], "x".join(map(str, shape))
    run = ranks[0][(name, shape)]
    for k, got in run["steps"][0]["mu"].items():
        want = ref[f"{tag}/mu0/{k}"]
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                      1e-30), (k, "mu")
    for i in range(STEPS):
        for k, got in run["steps"][i]["p"].items():
            want = ref[f"{tag}/p{i}/{k}"]
            assert got.shape == want.shape, k
            assert np.abs(got - want).max() <= 1e-4 * max(
                1.0, np.abs(want).max()), (k, i)


def check_whole_leaves_equal(ranks, name, shape):
    for i in range(STEPS):
        first = ranks[0][(name, shape)]["steps"][i]["whole"]
        assert first, "no whole leaves"
        for out in ranks[1:]:
            assert out[(name, shape)]["steps"][i]["whole"] == first, i


DENSE = ("gemma3-1b", "qwen1.5-4b")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_file(tmp_path_factory.mktemp("tp"), DENSE + tuple(VARIANTS),
                    ("gemma3-1b",))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grad_norm_match_the_reference_mesh_step(results, name,
                                                          shape):
    check_metrics(*results, name, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", DENSE)
def test_leaves_gathered_back_match_the_reference(results, name, shape):
    check_leaves(*results, name, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", DENSE)
def test_whole_leaves_are_bitwise_equal_on_every_rank(results, name, shape):
    check_whole_leaves_equal(results[1], name, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_zero_moments_hold_their_spec_share(results, shape):
    """With ``state_specs(zero=True)`` a rank's mu holds its spec's
    elements: a quarter of the parameters' whole on (1, 4) (model-sharded
    leaves) and less again on (2, 2) (the data slices)."""
    _, ranks = results
    for out in ranks:
        run = out[("gemma3-1b", shape)]
        assert run["mu_elements"] == run["mu_want"]
        assert run["mu_elements"] < run["whole_elements"]
    if shape == (2, 2):
        one = ranks[0][("gemma3-1b", (1, 4))]["mu_elements"]
        assert ranks[0][("gemma3-1b", shape)]["mu_elements"] < one


def test_zero_step_is_bitwise_the_unsliced_step(results):
    _, ranks = results
    for out in ranks:
        a, b = out[("gemma3-1b", (2, 2))], out[("gemma3-1b", "nozero")]
        assert a["mu_elements"] < b["mu_elements"]
        for i in range(STEPS):
            assert a["steps"][i]["loss"] == b["steps"][i]["loss"]
            assert a["steps"][i]["whole"] == b["steps"][i]["whole"]
    for k, p in ranks[0][("gemma3-1b", (2, 2))]["steps"][1]["p"].items():
        assert np.array_equal(
            p, ranks[0][("gemma3-1b", "nozero")]["steps"][1]["p"][k]), k


def _close_leaves(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= 1e-4 * max(1.0,
                                                      np.abs(v).max()), k


@pytest.mark.parametrize("shape", MESHES)
def test_microbatches_over_a_mesh_match_the_one_device_step(results, shape):
    """2 microbatches a step, each rank holding its part of both
    (``local_batch``): the mesh's step is the one-device step with 2
    microbatches on the same batch, loss and grad norm rel 1e-5,
    parameters within 1e-4 x max(1, max |leaf|)."""
    (loss, gnorm, got), (loss1, gnorm1, want) = \
        results[1][0][("gemma3-1b", "micro", shape)]
    assert loss == pytest.approx(loss1, rel=1e-5)
    assert gnorm == pytest.approx(gnorm1, rel=1e-5)
    _close_leaves(got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_microbatches_over_a_mesh_match_the_reference_mesh_step(results,
                                                                shape):
    """The same step against the reference's ``jit`` mesh step with 2
    microbatches (rows 0, 1 | 2, 3 of the global batch; row r's first 8 r
    labels masked, so another grouping of the rows gives other means)."""
    ref, tag = results[0]["gemma3-1b"], "x".join(map(str, shape))
    loss, gnorm, got = results[1][0][("gemma3-1b", "micro", shape)][0]
    assert loss == pytest.approx(float(ref[f"{tag}/micro/loss"]), rel=1e-5)
    assert gnorm == pytest.approx(float(ref[f"{tag}/micro/grad_norm"]),
                                  rel=1e-5)
    _close_leaves(got, {k[len(f"{tag}/micro/p/"):]: v for k, v in ref.items()
                        if k.startswith(f"{tag}/micro/p/")})


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_heads_not_dividing_the_model_axis_match_the_reference(results,
                                                               name):
    """The attention paths of :data:`VARIANTS` on (1, 4), held to the
    reference's mesh step as the dense configs are: loss, grad norm,
    leaves gathered back, whole leaves across ranks."""
    cfg, m = config(name), 4
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if name == "gemma3-1b-h12kv6":          # local heads, straddled groups
        hl, g = hq // m, hq // hkv
        assert hq % m == 0 and hkv % m and hl % g and g % hl
    elif name == "qwen1.5-4b-h3d6":         # wq / wo whole
        assert hq * hd % m
    else:                                   # wq / wo split inside a head
        assert hq % m and hq * hd % m == 0
    check_metrics(*results, name, (1, 4))
    check_leaves(*results, name, (1, 4))
    check_whole_leaves_equal(results[1], name, (1, 4))


def test_a_mesh_of_one_rank_is_bitwise_the_one_device_step():
    from repro_torch.configs import get_arch
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_arch("gemma3-1b").smoke()
    tc = TT.TrainConfig(remat=True)
    state = TT.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    batch = {"tokens": toks, "labels": toks}
    mesh = Mesh(np.zeros((1, 1), dtype=np.int64), ("data", "model"))
    a, ma = TT.train_step(cfg, tc, state, batch)
    b, mb = TT.train_step(cfg, tc, state, batch, mesh=mesh)
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt.mu),
                    tree_leaves(b.params) + tree_leaves(b.opt.mu)):
        assert torch.equal(x, y)


LAUNCH = ["--arch", "gemma3-1b", "--smoke", "--mesh", "single", "--device",
          "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
          "--log-every", "1"]


def launcher_rank(rank, world, micro=1):
    """``launch.train --mesh single`` on this rank with the production mesh
    patched to (data 2, model 2), and the same steps as a direct
    ``train_step`` loop (``test_torch_train.py``), ``micro`` microbatches
    a step: (printed lines, launcher's losses, the loop's losses)."""
    import contextlib
    import io

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    from repro_torch.launch.shardings import local_batch, shard_params
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import AdamWConfig, warmup_cosine

    def small_mesh(*, multi_pod=False, dgro_order=False):
        order, report = M.dgro_host_order(M.model_dcn_latency(2))
        mesh = M.Mesh(np.arange(4).reshape(2, 2)[order], ("data", "model"))
        mesh.dgro_report = report
        return mesh

    train.make_production_mesh = small_mesh
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = train.main(LAUNCH + ["--microbatches", str(micro)])

    cfg = get_arch("gemma3-1b").smoke()
    mesh = small_mesh()
    tc = TT.TrainConfig(optimizer=AdamWConfig(
        lr=3e-3, weight_decay=0.1,
        schedule=warmup_cosine(3e-3, warmup=5, total=3)), remat=False,
        microbatches=micro)
    specs = TT.state_layout(cfg, mesh)
    state = shard_params(TT.init_state(
        cfg, torch.Generator().manual_seed(0), device="cpu"), specs, mesh,
        rank)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, mean_doc_len=16))
    direct = []
    for step in range(3):
        b = local_batch({k: torch.from_numpy(v)
                         for k, v in data.batch(step).items()}, mesh, rank,
                        microbatches=micro)
        state, met = TT.train_step(cfg, tc, state, b, mesh=mesh,
                                   specs=specs)
        direct.append(float(met["loss"]))
    return buf.getvalue(), losses, direct
