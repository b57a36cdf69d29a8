"""The port's MoE family against the JAX package, on the CPU.

The same numpy inputs and the JAX package's own parameters (carried across
by ``convert.params_from_jax``) go through both.  JAX runs as its own
tests run it (``tests/test_models.py``): the plain jnp model on the CPU.
The configs are moonshot-v1-16b-a3b smoke (every layer MoE, top-2 of 8
experts, a shared expert) and llama4-maverick smoke without its vision
frontend (``frontend=None`` in both packages: a dense layer, then an MoE
layer, top-1, a shared expert).

Tolerances, with their reasons:
  * ``moe_apply``: y rtol 1e-5, atol 1e-6 (fp32 products summed in another
    order); router probabilities the same; expert ids, slots and the
    dropped set equal.
  * Router aux loss: 1e-6 (a mean of fp32 products).
  * Whole models: the LM tests' rtol = atol = 1e-4; aux within 1e-6.
  * Greedy tokens: identical.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import model as JM
from repro.models import moe as JMoE

from repro_torch.configs import get_arch
from repro_torch.launch.serve import generate
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.train import train_step as TT
from test_torch_lm import _jax_serve_loop

RTOL = ATOL = 1e-4
ROOT = os.path.join(os.path.dirname(__file__), "..")
MOONSHOT = "moonshot-v1-16b-a3b"
LLAMA4 = "llama4-maverick-400b-a17b"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(name, **kw):
    """Smoke configs of both packages; llama4 without its frontend."""
    if name == LLAMA4:
        kw.setdefault("frontend", None)
    jc, tc = jget_arch(name).smoke(), get_arch(name).smoke()
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _moe_params(jcfg, seed=0):
    jp = JMoE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


def _jax_dispatch(jprobs, jcfg):
    """The reference's routing of ``_moe_local`` (``moe.py:63-75``) from its
    probabilities: expert ids, each copy's slot, and which are kept."""
    t, e, k = jprobs.shape[0], jcfg.n_experts, jcfg.top_k
    _, eid = jax.lax.top_k(jprobs, k)
    eid_f = eid.reshape(-1)
    onehot = jax.nn.one_hot(eid_f, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0)[jnp.arange(t * k), eid_f] - 1
    return (np.asarray(eid), np.asarray(pos),
            np.asarray(pos < JMoE._capacity(t, jcfg)))


# --- the layer --------------------------------------------------------------

@pytest.mark.parametrize("name", [MOONSHOT, LLAMA4])
@pytest.mark.parametrize("t", [1, 7, 8, 48, 100, 1000, 8192])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_jax(name, t, cf):
    jcfg, tcfg = jget_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    for jc, tc in ((jcfg, tcfg), (jcfg.smoke(), tcfg.smoke())):
        c = TMoE._capacity(t, tc)
        assert c == JMoE._capacity(t, jc)
        assert c >= 4 and c % 4 == 0


def test_capacity_at_the_served_shapes():
    """moonshot at full width: a prefill of 8 x 1024 tokens, a decode step
    of 8 tokens, a training batch of 4 x 1024."""
    cfg = get_arch(MOONSHOT)
    assert [TMoE._capacity(t, cfg) for t in (8192, 8, 4096)] == [964, 4, 484]


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_matches_jax(cf):
    jcfg, tcfg = _cfgs(MOONSHOT, capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(1).normal(0, 1, (3, 16, jcfg.d_model)) \
        .astype(np.float32)
    jy, jprobs = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, tprobs = TMoE.moe_apply(tp, _t(x), tcfg)
    np.testing.assert_allclose(tprobs.numpy(), _np(jprobs), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=1e-5, atol=1e-6)

    jeid, jslot, jkeep = _jax_dispatch(jprobs, jcfg)
    gate, eid, slot, keep = TMoE.route(tprobs, tcfg,
                                       TMoE._capacity(48, tcfg))
    np.testing.assert_array_equal(eid.numpy(), jeid)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, rtol=1e-6)
    dropped = int((~keep).sum())
    if cf == 0.5:
        assert dropped > 0                  # the drop path is exercised
        # a token with every copy dropped gets no routed output at all
        gone = (~keep).reshape(48, -1).all(-1).numpy()
        assert gone.any() and not ty.reshape(48, -1)[gone].any()
    else:
        assert dropped == 0


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_dispatch_codes_match_jax_dispatch(cf):
    """``dispatch_codes``: 2 where the reference keeps a copy of the token
    for that expert, 1 where it drops one, 0 elsewhere."""
    jcfg, tcfg = _cfgs(MOONSHOT, capacity_factor=cf)
    probs = np.random.default_rng(2).dirichlet(
        np.full(jcfg.n_experts, 0.3), size=64).astype(np.float32)
    jeid, _, jkeep = _jax_dispatch(jnp.asarray(probs), jcfg)
    want = np.zeros((64, jcfg.n_experts), np.int8)
    np.put_along_axis(want, np.asarray(jeid).reshape(64, -1),
                      1 + np.asarray(jkeep).reshape(64, -1), axis=1)
    got = TMoE.dispatch_codes(_t(probs), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    if cf == 0.5:
        assert (got == 1).any()             # the drop code is exercised


def test_moe_gradients_match_jax_grad_with_drops():
    """Gradients of every MoE weight and of x through the dispatch (cf 0.5:
    copies dropped) against ``jax.grad`` of the reference."""
    jcfg, tcfg = _cfgs(MOONSHOT, capacity_factor=0.5)
    jp, tp = _moe_params(jcfg, seed=3)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, xx):
        y, probs = JMoE.moe_apply(p, xx, jcfg)
        return jnp.sum(y * w) + JMoE.router_aux_loss(probs)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = _t(x).requires_grad_()
    y, probs = TMoE.moe_apply(tp, tx, tcfg)
    (torch.sum(y * _t(w)) + TMoE.router_aux_loss(probs)).backward()
    for k, v in tp.items():
        want = _np(jg[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgx), rtol=1e-4,
                               atol=1e-6)


def test_moe_forward_and_backward_are_repeatable():
    """Two runs give the same bits, forward and backward (no atomics)."""
    _, tcfg = _cfgs(MOONSHOT, capacity_factor=0.5)
    _, tp = _moe_params(_cfgs(MOONSHOT)[0], seed=4)
    x = _t(np.random.default_rng(4).normal(0, 1, (2, 20, tcfg.d_model)))
    out = []
    for _ in range(2):
        ps = {k: v.clone().requires_grad_() for k, v in tp.items()}
        xx = x.clone().requires_grad_()
        y, probs = TMoE.moe_apply(ps, xx, tcfg)
        (y.square().sum() + TMoE.router_aux_loss(probs)).backward()
        out.append([y.detach(), xx.grad] + [ps[k].grad for k in sorted(ps)])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_top_k_ties_go_to_the_lower_expert_id():
    """Exactly tied probabilities route as ``jax.lax.top_k`` does."""
    _, tcfg = _cfgs(MOONSHOT)
    jcfg = dataclasses.replace(jget_arch(MOONSHOT).smoke(), top_k=3)
    tcfg = dataclasses.replace(tcfg, top_k=3)
    rng = np.random.default_rng(5)
    probs = rng.choice([0.05, 0.1, 0.2], size=(64, 8)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    jeid, jslot, jkeep = _jax_dispatch(jnp.asarray(probs), jcfg)
    _, eid, slot, keep = TMoE.route(_t(probs), tcfg,
                                    TMoE._capacity(64, tcfg))
    np.testing.assert_array_equal(eid.numpy(), jeid)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(keep.numpy(), jkeep)


@pytest.mark.parametrize("given", [False, True])
def test_router_aux_loss_matches_jax(given):
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 1.4, (300, 64)).astype(np.float32)
    logits[:5, 7] = logits[:5, 3] = 9.0          # tied top-1 choices
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top1 = rng.integers(0, 64, 300) if given else None
    want = float(JMoE.router_aux_loss(
        jnp.asarray(probs), None if top1 is None else jnp.asarray(top1)))
    got = float(TMoE.router_aux_loss(
        _t(probs), None if top1 is None else torch.from_numpy(top1)))
    assert got == pytest.approx(want, abs=1e-6)


def test_init_moe_layout_and_a_mesh_raises():
    """The layout, and a mesh whose model axis does not divide the experts
    raises (the reference asserts E % m == 0)."""
    from repro_torch.launch.mesh import Mesh

    jcfg, tcfg = _cfgs(MOONSHOT)
    want = {k: v.shape for k, v in JMoE.init_moe(
        jax.random.PRNGKey(0), jcfg, jnp.bfloat16).items()}
    got = TMoE.init_moe(torch.Generator().manual_seed(0), tcfg,
                        torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert got["router"].dtype == torch.float32
    assert got["w_down"].dtype == torch.bfloat16
    x = torch.zeros(1, 4, tcfg.d_model)
    mesh = Mesh(np.arange(3).reshape(1, 3), ("data", "model"))
    with pytest.raises(ValueError, match="do not divide"):
        TMoE.moe_apply(got, x, tcfg, mesh=mesh)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_expert_parallel_matches_jax(tmp_path, shape):
    """``moe_apply(mesh=...)`` on 4 gloo ranks, each holding E / m experts
    and its data shard, against the JAX package's ``moe_apply`` on each
    data shard's tokens (the reference's ``shard_map`` body with its
    psum over model): y and the router probabilities rtol 1e-5, atol
    1e-6; the gradients of sum(y dy) + aux over every shard (tokens, router,
    each rank's experts) within 1e-5 x their max."""
    from repro_torch import distributed as D
    from test_torch_expert_parallel import ep_layer_rank

    jcfg, tcfg = _cfgs(MOONSHOT)
    rng = np.random.default_rng(11)
    p = {k: _np(v) for k, v in JMoE.init_moe(
        jax.random.PRNGKey(3), jcfg, jnp.float32).items()}
    x = rng.normal(0, 1, (4, 16, jcfg.d_model)).astype(np.float32)
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    np.savez(tmp_path / "layer.npz", x=x, dy=dy, **p)
    ranks = D.spawn_ranks(ep_layer_rank, 4,
                          args=(str(tmp_path / "layer.npz"), shape),
                          timeout=120, workdir=str(tmp_path))

    d, m = shape

    def loss(p, x):
        ys, probs = zip(*(JMoE.moe_apply(p, xs, jcfg)
                          for xs in jnp.split(x, d)))
        y = jnp.concatenate(ys)
        return (jnp.sum(y * dy) + JMoE.router_aux_loss(
            jnp.concatenate(probs))), (y, jnp.concatenate(probs))

    (_, (y, probs)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    el, bl = jcfg.n_experts // m, x.shape[0] // d
    for r, out in enumerate(ranks):
        di, mi = divmod(r, m)
        rows = slice(di * bl, (di + 1) * bl)
        np.testing.assert_allclose(out["y"], _np(y)[rows], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["probs"], _np(probs), rtol=1e-5,
                                   atol=1e-6)
        for got, want in ((out["gx"], _np(gx)[rows]),
                          (out["grouter"], _np(gp["router"])),
                          (out["gw_gate"],
                           _np(gp["w_gate"])[mi * el:(mi + 1) * el])):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# --- whole models ------------------------------------------------------------

def _carried(jcfg, tcfg):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")


@pytest.mark.parametrize("name", [MOONSHOT, LLAMA4])
def test_forward_all_modes_match_jax(name):
    """train, train_hidden, prefill and three decode steps, with the aux
    loss of the train modes and of prefill."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _carried(jcfg, tcfg)
    assert TM.pattern_period(tcfg) == JM.pattern_period(jcfg)
    assert [TM.layer_kind(tcfg, j)["type"]
            for j in range(TM.pattern_period(tcfg))] == \
        [JM.layer_kind(jcfg, j)["type"]
         for j in range(JM.pattern_period(jcfg))]
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab, size=(2, 24))
    want, jaux = JM.forward(jcfg, jp, jnp.asarray(toks), mode="train")
    got, aux = TM.forward(tcfg, tp, torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    assert float(jaux) > 0
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)

    jx, jhead, jaux2 = JM.forward(jcfg, jp, jnp.asarray(toks),
                                  mode="train_hidden")
    x, head, aux2 = TM.forward(tcfg, tp, torch.from_numpy(toks),
                               mode="train_hidden", remat=True)
    np.testing.assert_allclose(x.numpy(), _np(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(head.numpy(), _np(jhead))
    assert float(aux2) == pytest.approx(float(jaux2), abs=1e-6)

    jc = JM.init_caches(jcfg, 2, 40)
    tc = TM.init_caches(tcfg, 2, 40, device="cpu")
    want, jc, jaux3 = JM.forward(jcfg, jp, jnp.asarray(toks), mode="prefill",
                                 caches=jc)
    got, tc, aux3 = TM.forward(tcfg, tp, torch.from_numpy(toks),
                               mode="prefill", caches=tc)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    assert float(aux3) == pytest.approx(float(jaux3), abs=1e-6)
    for i in range(3):
        nxt = rng.integers(1, jcfg.vocab, size=(2, 1))
        want, jc = JM.forward(jcfg, jp, jnp.asarray(nxt), mode="decode",
                              caches=jc, pos=jnp.int32(24 + i))
        got, tc = TM.forward(tcfg, tp, torch.from_numpy(nxt), mode="decode",
                             caches=tc, pos=24 + i)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)
    jflat = convert.flatten(jax.tree.map(np.asarray, jc))
    tflat = convert.flatten(tc)
    assert sorted(jflat) == sorted(tflat)
    for key, val in tflat.items():
        np.testing.assert_allclose(val.numpy(), jflat[key], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", [MOONSHOT, LLAMA4])
def test_generate_greedy_tokens_match_jax_serve_loop(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _carried(jcfg, tcfg)
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab, size=(3, 20))
    want = _jax_serve_loop(jcfg, jp, prompts, max_new=8, max_len=32)
    got, _ = generate(tcfg, tp, prompts, max_new=8, max_len=32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", [MOONSHOT, LLAMA4])
def test_full_width_layout_matches_jax(name):
    """The full-width trees (llama4 without its frontend), on the ``meta``
    device against ``jax.eval_shape``: no memory is allocated."""
    jcfg, tcfg = jget_arch(name), get_arch(name)
    if name == LLAMA4:
        jcfg = dataclasses.replace(jcfg, frontend=None)
        tcfg = dataclasses.replace(tcfg, frontend=None)
    want = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    dtypes = {n: s.dtype for n, s in convert.flatten(want).items()}
    want = {n: tuple(s.shape) for n, s in convert.flatten(want).items()}
    assert convert.param_shapes(tcfg) == want
    meta = convert.flatten(TM.init_params(tcfg, device="meta"))
    assert {n: str(t.dtype)[6:] for n, t in meta.items()} == \
        {n: str(d) for n, d in dtypes.items()}
    n = sum(int(np.prod(s)) for s in want.values())
    assert TM.param_count(TM.init_params(tcfg, device="meta")) == n
    if name == MOONSHOT:
        assert n == 28_888_467_456
        assert "blocks/pos0/moe/w_gate" in want and "rem" not in str(want)
    else:                                   # pos0 dense, pos1 MoE
        assert "blocks/pos0/mlp/w_up" in want
        assert "blocks/pos1/moe/router" in want
        assert "blocks/pos1/shared_mlp/w_down" in want


@pytest.mark.parametrize("remat", [False, True])
def test_loss_adds_the_weighted_aux_in_both_ce_paths(remat):
    """``loss_fn``'s total is ce + aux_weight x aux whether the CE takes the
    logits or the chunked hidden states; aux is nonzero for an MoE stack."""
    jcfg, tcfg = _cfgs(MOONSHOT)
    _, tp = _carried(jcfg, tcfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, tcfg.vocab, (2, 24)))
    batch = {"tokens": toks, "labels": toks}
    out = []
    for chunk in (0, 8):
        tc = TT.TrainConfig(remat=remat, ce_chunk=chunk)
        with torch.no_grad():
            total, m = TT.loss_fn(tcfg, tc, tp, batch)
        assert float(m["aux"]) > 0
        assert float(total) == pytest.approx(
            float(m["ce"]) + tc.aux_weight * float(m["aux"]), rel=1e-6)
        out.append((float(total), float(m["aux"])))
    assert out[0][1] == out[1][1]
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)


def test_params_from_jax_keeps_the_router_fp32():
    jcfg, tcfg = _cfgs(LLAMA4)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    got = convert.flatten(convert.params_from_jax(jp, tcfg, device="cpu",
                                                  dtype=torch.bfloat16))
    for name, t in got.items():
        want = torch.float32 if name.endswith("moe/router") else \
            torch.bfloat16
        assert t.dtype == want, name
    np.testing.assert_array_equal(got["blocks/pos1/moe/router"].numpy(),
                                  jp["blocks"]["pos1"]["moe"]["router"])


def test_unported_families_and_frontends_still_raise():
    """The frontend configs, refused before their port, now initialise and
    run a smoke forward (their parity: ``tests/test_torch_frontend.py``);
    an unknown family or frontend still raises."""
    toks = torch.from_numpy(np.random.default_rng(4).integers(1, 256, (2, 6)))
    for name in (LLAMA4, "musicgen-large", "pixtral-12b"):
        cfg = get_arch(name).smoke()
        params = TM.init_params(cfg, device="cpu")
        assert ("vision_proj" in params) == (cfg.frontend == "vision")
        vis = torch.zeros((2, cfg.n_patches, cfg.d_model)) \
            if cfg.frontend == "vision" else None
        logits, _ = TM.forward(cfg, params, toks, vision_embeds=vis)
        extra = 0 if vis is None else cfg.n_patches
        assert logits.shape == (2, 6 + extra, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
    for name in (MOONSHOT, "falcon-mamba-7b", "zamba2-7b"):
        TM.check_supported(get_arch(name))
    for bad in (dict(family="diffusion"), dict(frontend="video")):
        with pytest.raises(NotImplementedError):
            TM.check_supported(dataclasses.replace(get_arch(MOONSHOT), **bad))


# --- CLIs --------------------------------------------------------------------

def _cli(module, *args):
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin")}
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", MOONSHOT, "--smoke",
         "--device", "cpu", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


def test_serve_cli_runs_moonshot_smoke_on_cpu():
    out = _cli("repro_torch.launch.serve", "--requests", "2",
               "--prompt-len", "20", "--max-new", "4")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("[serve]") == 3, out.stdout
    assert f"arch={MOONSHOT}-smoke" in out.stdout


def test_train_cli_runs_moonshot_smoke_on_cpu():
    out = _cli("repro_torch.launch.train", "--steps", "3", "--batch", "4",
               "--seq", "32", "--log-every", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"[train] arch={MOONSHOT}-smoke layers=2")
    assert sum(line.startswith("step ") for line in lines) == 3
    assert lines[-1].startswith("[done] 3 steps")
