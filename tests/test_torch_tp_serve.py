"""Serving over a ("data", "model") mesh (``repro_torch``: prefill, decode
and greedy tokens with each rank's blocks of the parameters and the caches)
against the JAX package's mesh step, on the CPU: the attention families
here (gemma3-1b: one KV head, its caches split over slots; qwen1.5-4b and
musicgen-large: caches split over heads; pixtral-12b with patches;
moonshot-v1-16b-a3b: expert-parallel MoE decode).
``test_torch_ssm_tp.py`` (falcon-mamba-7b, zamba2-7b) uses the machinery of
this file.

The reference is ``repro.models.model.forward`` under ``jit`` with the
``param_specs`` / ``cache_specs`` / ``batch_specs`` shardings under
``default_rules``, on ``make_mesh`` of 4 forced host devices, the caches
put back by ``device_put`` after each step (the shape of
``repro/launch/dryrun.py``'s prefill and decode steps).  It runs once a
file, in a subprocess, which writes each config's parameters and inputs
first, so the port's 4 gloo ranks start while it compiles.  The ranks carry
the parameters across (``convert.params_from_jax``), keep their blocks
(``shard_params``), allocate only their blocks of the caches
(``init_caches(mesh=, rank=)``) and serve their rows of the batch; each
logits row and cache is gathered back for the comparison.  Each case
prefills a prompt of :data:`PROMPT` tokens (past gemma3-1b's window of 16)
and decodes :data:`STEPS` tokens from the ranks' greedy picks.

Tolerances, with their reasons:
  * logits (prefill and every decode step): within 1e-5 x max |logit| of
    the reference's (the same fp32 arithmetic, summed in another order
    over ranks); greedy tokens equal;
  * caches gathered back after the last step: within 1e-5 x max |leaf|;
    fp8 caches byte for byte;
  * a case with an fp8 cache takes the bound of the two packages' fp8
    caches (``test_torch_fp8_cache.py``): an fp8 code is two significant
    digits, so a K/V value within a last bit of a rounding midpoint rounds
    to the next code when the two packages' fp32 products sum in another
    order, and the next steps read it (zamba2-7b's shared attention: 2 of
    32,768 V bytes).  Cache codes differ by at most 1, in at most 1 in 1000
    bytes; logits and the float leaves of the caches within 1e-4 x max
    |want| (the fp8 tests' rtol); greedy tokens equal.
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

BATCH, PROMPT, STEPS, RANKS = 4, 24, 8, 4
TOL, TOL_FP8 = 1e-5, 1e-4
# (config, mesh, cache dtype, max_len): every attention family on (1, 4),
# gemma3-1b and moonshot on (2, 2) too; gemma3-1b with an fp8 cache, and
# with a max_len that 4 does not divide (its global layers' caches whole on
# every rank, the local layers' 16 slots split)
CASES = (
    ("gemma3-1b", (1, 4), "fp32", 64),
    ("gemma3-1b", (2, 2), "fp32", 64),
    ("gemma3-1b", (1, 4), "fp8", 64),
    ("gemma3-1b", (1, 4), "fp32", 50),
    ("qwen1.5-4b", (1, 4), "fp32", 64),
    ("pixtral-12b", (1, 4), "fp32", 64),
    ("musicgen-large", (1, 4), "fp32", 64),
    ("moonshot-v1-16b-a3b", (1, 4), "fp32", 64),
    ("moonshot-v1-16b-a3b", (2, 2), "fp32", 64),
)


def tag(case) -> str:
    name, shape, cdt, max_len = case
    return f"{name}-{'x'.join(map(str, shape))}-{cdt}-{max_len}"


SERVE_CODE = r'''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.launch.shardings import (batch_specs, cache_specs, param_specs,
                                    to_shardings)
from repro.models import model as JM
from repro.models.sharding import default_rules, use_rules
from repro.train import train_step as JT

out_dir = sys.argv[1]
CASES = [tuple(c) for c in json.loads(sys.argv[2])]
BATCH, PROMPT, STEPS = (int(a) for a in sys.argv[3:6])
VARIANTS = json.loads(sys.argv[6])
DTYPES = {"fp32": jnp.float32, "fp8": jnp.float8_e4m3fn}


def config(name):
    base, kw = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(get_arch(base).smoke(), **kw)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            a = np.asarray(v)
            out[prefix + k] = a.view(np.uint8) \
                if a.dtype == jnp.float8_e4m3fn else a
    return out


def save(path, arrays):
    np.savez(path + ".tmp.npz", **arrays)
    os.rename(path + ".tmp.npz", path + ".npz")


def tag(case):
    name, shape, cdt, max_len = case
    return f"{name}-{'x'.join(map(str, shape))}-{cdt}-{max_len}"


params = {}
for case in CASES:
    name = case[0]
    cfg = config(name)
    if name not in params:
        params[name] = JT.init_state(cfg, jax.random.PRNGKey(0)).params
        save(os.path.join(out_dir, f"p0-{name}"), flat(params[name]))
    rng = np.random.default_rng(len(params))
    inp = {"prompts": rng.integers(1, cfg.vocab, (BATCH, PROMPT))
           .astype(np.int32)}
    if cfg.frontend == "vision":
        inp["vision"] = rng.normal(0, 1, (BATCH, cfg.n_patches, cfg.d_model)
                                   ).astype(np.float32)
    save(os.path.join(out_dir, f"in-{tag(case)}"), inp)

for case in CASES:
    name, shape, cdt, max_len = case
    cfg = config(name)
    inp = dict(np.load(os.path.join(out_dir, f"in-{tag(case)}.npz")))
    mesh = make_mesh(tuple(shape), ("data", "model"))
    rules = default_rules(("data",), mesh=mesh)
    p = params[name]
    p_shard = to_shardings(param_specs(jax.eval_shape(lambda: p), mesh),
                           mesh)
    caches = JM.init_caches(cfg, BATCH, max_len, dtype=DTYPES[cdt])
    c_shard = to_shardings(cache_specs(jax.eval_shape(lambda: caches), mesh,
                                       BATCH, ("data",)), mesh)
    b_shard = to_shardings(batch_specs(jax.eval_shape(
        lambda: {k: jnp.asarray(v) for k, v in inp.items()}), mesh,
        ("data",)), mesh)
    t_shard = to_shardings(batch_specs(jax.ShapeDtypeStruct(
        (BATCH, 1), jnp.int32), mesh, ("data",)), mesh)
    rep = NamedSharding(mesh, P())
    vision = "vision" in inp

    def prefill_fn(p, c, b):
        with use_rules(rules):
            return JM.forward(cfg, p, b["prompts"], mode="prefill", caches=c,
                              vision_embeds=b.get("vision"), mesh=mesh,
                              data_axes=("data",))[:2]

    def decode_fn(p, c, t, pos):
        with use_rules(rules):
            return JM.forward(cfg, p, t, mode="decode", caches=c, pos=pos,
                              mesh=mesh, data_axes=("data",))

    prefill = jax.jit(prefill_fn, in_shardings=(p_shard, c_shard, b_shard))
    decode = jax.jit(decode_fn, in_shardings=(p_shard, c_shard, t_shard,
                                              rep))
    jp = jax.device_put(p, p_shard)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in inp.items()},
                        b_shard)
    logits, c = prefill(jp, jax.device_put(caches, c_shard), jb)
    c = jax.device_put(c, c_shard)
    out = {"logits0": np.asarray(logits)}
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)
    toks = [tok]
    start = PROMPT + (cfg.n_patches if vision else 0)
    for i in range(STEPS):
        logits, c = decode(jp, c, jnp.asarray(tok[:, None]),
                           jnp.int32(start + i))
        c = jax.device_put(c, c_shard)
        out[f"logits{i + 1}"] = np.asarray(logits)
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)
        toks.append(tok)
    out["tokens"] = np.stack(toks, 1)
    out.update({f"cache/{k}": v for k, v in flat(c).items()})
    save(os.path.join(out_dir, f"ref-{tag(case)}"), out)

if len(sys.argv) > 7:
    # the training half's reference (test_torch_tensor_parallel's code)
    train_code = open(sys.argv[7]).read()
    sys.argv = [sys.argv[0]] + json.loads(sys.argv[8])
    exec(compile(train_code, "train_reference", "exec"))
else:
    print("OK")
'''


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def config(name, variants=None):
    """The smoke config of ``name``, or of a ``variants`` entry (name ->
    (base config, fields replaced))."""
    from repro_torch.configs import get_arch

    base, kw = (variants or {}).get(name, (name, {}))
    return dataclasses.replace(get_arch(base).smoke(), **kw)


def start_reference(tmp, cases, variants=None, train=None):
    """The reference in a subprocess for ``cases`` (and, with ``train`` =
    (code path, argv list), the training reference after them)."""
    args = [sys.executable, "-c", SERVE_CODE, str(tmp),
            json.dumps([[n, list(s), c, m] for n, s, c, m in cases]),
            str(BATCH), str(PROMPT), str(STEPS), json.dumps(variants or {})]
    if train is not None:
        args += [train[0], json.dumps(train[1])]
    return subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=subproc_env(), cwd=".")


def wait_for(path, proc, seconds=240):
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        assert proc.poll() is None, proc.communicate()[1][-3000:]
        assert time.monotonic() < deadline, f"no {path}"
        time.sleep(0.1)


def _whole(t: torch.Tensor):
    """A gathered leaf as numpy (fp8 as its bytes)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.contiguous().view(torch.uint8).numpy()
    return t.numpy()


def serve_case(case, ref_dir, rank, variants=None):
    """One case on this rank: prefill and :data:`STEPS` greedy decode steps
    over the mesh.  Returns (tokens, and on rank 0 the gathered logits of
    every step and the caches gathered back)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import greedy
    from repro_torch.launch.shardings import (batch_specs, gather_leaf,
                                              local_slice, param_specs,
                                              shard_params,
                                              tree_map_with_path)
    from repro_torch.models import convert
    from repro_torch.models import model as Mdl
    from repro_torch.models.convert import flatten
    from repro_torch.models.sharding import P

    from test_torch_tensor_parallel import _unflatten

    name, shape, cdt, max_len = case
    cfg = config(name, variants)
    wait = os.path.join(ref_dir, f"in-{tag(case)}.npz")
    while not os.path.exists(wait):
        time.sleep(0.1)
    inp = _load(wait)
    p0 = _load(os.path.join(ref_dir, f"p0-{name}.npz"))
    params = convert.params_from_jax(
        _unflatten(p0, Mdl.init_params(cfg, device="meta")), cfg,
        device="cpu")
    mesh = Mesh(np.arange(RANKS).reshape(shape), ("data", "model"))
    local = shard_params(params, param_specs(params, mesh), mesh, rank)
    dtype = {"fp32": torch.float32, "fp8": torch.float8_e4m3fn}[cdt]
    caches = Mdl.init_caches(cfg, BATCH, max_len, dtype, "cpu", mesh=mesh,
                             rank=rank)
    tp, _ = Mdl.mesh_groups(mesh)
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    bs = batch_specs(batch, mesh)
    mine = {k: local_slice(v, bs[k], mesh, rank) for k, v in batch.items()}
    rows = bs["prompts"][0]
    cols = "model" if Mdl.head_range(cfg, local, tp) is not None else None
    logit_spec = P(rows, cols)
    kw = dict(mesh=mesh, max_len=max_len)
    logits, caches, _ = Mdl.forward(
        cfg, local, mine["prompts"].long(), mode="prefill", caches=caches,
        vision_embeds=mine.get("vision"), **kw)
    seen = [gather_leaf(logits, logit_spec, mesh)]
    toks = [greedy(cfg, local, logits, tp)]
    start = PROMPT + (cfg.n_patches if "vision" in mine else 0)
    for i in range(STEPS):
        logits, caches = Mdl.forward(cfg, local, toks[-1][:, None],
                                     mode="decode", caches=caches,
                                     pos=start + i, **kw)
        seen.append(gather_leaf(logits, logit_spec, mesh))
        toks.append(greedy(cfg, local, logits, tp))
    tokens = gather_leaf(torch.stack(toks, 1), P(rows, None), mesh)
    specs = Mdl.cache_layout(cfg, BATCH, max_len, mesh, dtype=dtype)
    whole = tree_map_with_path(lambda path, c, sp: gather_leaf(c, sp, mesh),
                               caches, specs)
    if rank:
        return tokens.numpy(), None
    return tokens.numpy(), {
        "logits": [g.numpy() for g in seen],
        "caches": {k: _whole(v) for k, v in flatten(whole).items()}}


def serve_rank(rank, world, ref_dir, cases):
    torch.use_deterministic_algorithms(True)
    return {tag(c): serve_case(c, ref_dir, rank) for c in cases}


def wait_done(proc, timeout=300) -> None:
    """The reference's end: its "OK", or its error."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "OK" in stdout, stderr[-3000:]


def run_file(tmp, cases):
    tmp = str(tmp)
    proc = start_reference(tmp, cases)
    try:
        ranks = D.spawn_ranks(serve_rank, RANKS, args=(tmp, cases),
                              timeout=300, workdir=tmp)
    finally:
        wait_done(proc)
    return {tag(c): _load(os.path.join(tmp, f"ref-{tag(c)}.npz"))
            for c in cases}, ranks


def _tol(case) -> float:
    return TOL_FP8 if case[2] == "fp8" else TOL


def check_logits(ref, ranks, case):
    want, got = ref[tag(case)], ranks[0][tag(case)][1]["logits"]
    assert len(got) == STEPS + 1
    for i, g in enumerate(got):
        w = want[f"logits{i}"]
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.abs(g - w).max() <= _tol(case) * np.abs(w).max(), i


def check_tokens(ref, ranks, case):
    want = ref[tag(case)]["tokens"]
    for out in ranks:
        assert np.array_equal(out[tag(case)][0], want)


def check_caches(ref, ranks, case):
    want, got = ref[tag(case)], ranks[0][tag(case)][1]["caches"]
    assert {f"cache/{k}" for k in got} == {k for k in want
                                           if k.startswith("cache/")}
    for k, g in got.items():
        w = want[f"cache/{k}"]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if g.dtype == np.uint8:
            # e4m3 codes: sign bit, then a magnitude order
            step = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert (step <= 1).all() and (g >> 7 == w >> 7).all(), k
            assert (step > 0).mean() <= 1e-3, k
        else:
            assert np.abs(g - w).max() <= _tol(case) * max(np.abs(w).max(),
                                                           1e-30), k


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_file(tmp_path_factory.mktemp("tp_serve"), CASES)


@pytest.mark.parametrize("case", CASES, ids=tag)
def test_logits_match_the_reference_mesh_step(results, case):
    check_logits(*results, case)


@pytest.mark.parametrize("case", CASES, ids=tag)
def test_greedy_tokens_match_the_reference(results, case):
    check_tokens(*results, case)


@pytest.mark.parametrize("case", CASES, ids=tag)
def test_caches_gathered_back_match_the_reference(results, case):
    check_caches(*results, case)


# --- the entry points: generate and the serve CLI over a mesh ---------------

LAUNCH = ["--smoke", "--device", "cpu", "--requests", "4", "--prompt-len",
          "24", "--max-new", "9", "--max-len", "64"]


def launcher_rank(rank, world):
    """``launch.serve`` on this rank over (1, 4) and (2, 2) (``--mesh single
    --mesh-shape``) and without a mesh, and ``generate`` over (1, 4) from
    the same whole parameters: (printed lines, tokens by run)."""
    import contextlib
    import io

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shardings import param_specs, shard_params
    from repro_torch.models import model as Mdl

    torch.use_deterministic_algorithms(True)
    out, printed = {}, {}
    for arch in ("gemma3-1b", "zamba2-7b"):
        for mesh in ("1,4", "2,2", None):
            buf = io.StringIO()
            flags = ["--arch", arch] + LAUNCH
            if mesh:
                flags += ["--mesh", "single", "--mesh-shape", mesh]
            with contextlib.redirect_stdout(buf):
                out[(arch, mesh)] = serve.main(flags)
            printed[(arch, mesh)] = buf.getvalue()
        cfg = get_arch(arch).smoke()
        params = Mdl.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        mesh = Mesh(np.arange(4).reshape(1, 4), ("data", "model"))
        local = shard_params(params, param_specs(params, mesh), mesh, rank)
        prompts = np.random.default_rng(0).integers(1, cfg.vocab, (4, 24))
        out[(arch, "generate")] = serve.generate(
            cfg, local, prompts, 9, 64, mesh=mesh)[0].numpy()
    return printed, out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    return D.spawn_ranks(launcher_rank, RANKS, timeout=300,
                         workdir=str(tmp_path_factory.mktemp("serve_cli")))


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-7b"])
@pytest.mark.parametrize("mesh", ["1,4", "2,2"])
def test_serve_cli_over_a_mesh_gives_the_one_device_tokens(launched, arch,
                                                           mesh):
    """Every rank returns the whole batch's tokens, those of the CLI
    without a mesh (the same seed's parameters); only rank 0 prints, its
    three ``[serve]`` lines and the mesh's."""
    for rank, (printed, out) in enumerate(launched):
        assert np.array_equal(out[(arch, mesh)], out[(arch, None)])
        lines = printed[(arch, mesh)].splitlines()
        if rank:
            assert lines == []
        else:
            assert len([l for l in lines if l.startswith("[serve]")]) == 4
            assert lines[0].startswith("[serve] mesh")


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-7b"])
def test_generate_over_a_mesh_gives_the_one_device_tokens(launched, arch):
    for _, out in launched:
        assert np.array_equal(out[(arch, "generate")], out[(arch, None)])
