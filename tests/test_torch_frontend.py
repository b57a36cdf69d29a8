"""The port's frontend families against the JAX package, on the CPU:
pixtral-12b (family "vlm", the vision stub), musicgen-large (family
"audio", GELU, Hq = Hkv) and llama4-maverick with its vision fusion (MoE
and frontend), at smoke size.

The same numpy inputs -- tokens, and the vision configs' patch embeddings
(B, Np, d) -- and the JAX package's own parameters (carried across by
``convert.params_from_jax``, ``vision_proj`` among them) go through both.
JAX runs as its own tests run it: the plain jnp model, jitted, one
trajectory a config (``functools.lru_cache``).  On the CPU the port's
kernel wrappers take their plain versions; the kernels are held to those on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances, with their reasons:
  * Logits (prefill and every decode step, teacher-forced on the
    reference's greedy tokens): the LM tests' rtol = atol = 1e-4 (fp32
    matmuls summed in another order, RoPE's cos / sin by ulps).
  * Greedy tokens of ``launch.serve.generate``: identical.
  * ``loss_fn`` and ``train_step``: loss, ce and grad norm rtol 1e-5 and
    n_tok exact; parameters after the steps rtol 1e-4, atol 1e-4 (the
    training tests' ``test_train_step_matches_jax``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import model as JM
from repro.train import train_step as JT
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import warmup_cosine as jwarmup_cosine

from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.train import train_step as TT
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         tree_leaves, warmup_cosine)

RTOL = ATOL = 1e-4
PIXTRAL, MUSICGEN = "pixtral-12b", "musicgen-large"
LLAMA4 = "llama4-maverick-400b-a17b"
FRONTENDS = [PIXTRAL, MUSICGEN, LLAMA4]
B, PROMPT, NEW, MAX_LEN = 2, 12, 6, 32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(cfg, seed=0):
    """Prompts (B, PROMPT) and, for a vision config, patch embeddings
    (B, Np, d), from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, PROMPT))
    vis = rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model)) \
        .astype(np.float32) if cfg.frontend == "vision" else None
    return toks, vis


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's greedy serve loop (its ``launch/serve.py`` with the
    patch embeddings of a vision config): prefill logits, each decode
    step's logits, the tokens; and the parameters, as numpy."""
    cfg = jget_arch(name).smoke()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    toks, vis = _inputs(cfg)
    n_vis = 0 if vis is None else vis.shape[1]
    prefill = jax.jit(lambda p, c, t, v: JM.forward(
        cfg, p, t, mode="prefill", caches=c, vision_embeds=v))
    decode = jax.jit(lambda p, c, t, pos: JM.forward(
        cfg, p, t, mode="decode", caches=c, pos=pos))
    caches = JM.init_caches(cfg, B, MAX_LEN)
    logits, caches, _ = prefill(params, caches, jnp.asarray(toks),
                                None if vis is None else jnp.asarray(vis))
    out, steps = [jnp.argmax(logits, -1).astype(jnp.int32)], [_np(logits)]
    for i in range(NEW - 1):
        logits, caches = decode(params, caches, out[-1][:, None],
                                jnp.int32(n_vis + PROMPT + i))
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
        steps.append(_np(logits))
    tokens = np.stack([np.asarray(o) for o in out], axis=1)
    return steps, tokens, jax.tree.map(np.asarray, params)


def _port(name):
    cfg = get_arch(name).smoke()
    _, _, jp = _reference(name)
    return cfg, convert.params_from_jax(jp, cfg, device="cpu")


@pytest.mark.parametrize("name", FRONTENDS)
def test_prefill_and_decode_logits_match_jax(name):
    steps, tokens, _ = _reference(name)
    cfg, params = _port(name)
    toks, vis = _inputs(cfg)
    n_vis = 0 if vis is None else vis.shape[1]
    caches = TM.init_caches(cfg, B, MAX_LEN, device="cpu")
    logits, caches, _ = TM.forward(
        cfg, params, torch.from_numpy(toks), mode="prefill", caches=caches,
        vision_embeds=None if vis is None else torch.from_numpy(vis))
    got = [logits.numpy()]
    for i in range(NEW - 1):
        logits, caches = TM.forward(
            cfg, params, torch.from_numpy(tokens[:, i:i + 1]).long(),
            mode="decode", caches=caches, pos=n_vis + PROMPT + i)
        got.append(logits.numpy())
    for i, (g, w) in enumerate(zip(got, steps)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("name", FRONTENDS)
def test_generate_greedy_tokens_match_jax(name):
    _, want, _ = _reference(name)
    cfg, params = _port(name)
    toks, vis = _inputs(cfg)
    got, t = serve.generate(
        cfg, params, toks, NEW, MAX_LEN,
        vision_embeds=None if vis is None else torch.from_numpy(vis))
    assert got.shape == (B, NEW) and t["prefill_s"] > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_vision_patches_change_the_output_and_text_only_still_runs():
    """Without ``vision_embeds`` a vision config runs text-only, as the
    reference does; with them the patches move every logit."""
    cfg, params = _port(PIXTRAL)
    toks, vis = _inputs(cfg)
    jcfg = jget_arch(PIXTRAL).smoke()
    _, _, jp = _reference(PIXTRAL)
    want, _ = JM.forward(jcfg, jax.tree.map(jnp.asarray, jp),
                         jnp.asarray(toks), mode="train")
    text, _ = TM.forward(cfg, params, torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(text.numpy(), _np(want), rtol=RTOL,
                               atol=ATOL)
    fused, _ = TM.forward(cfg, params, torch.from_numpy(toks), mode="train",
                          vision_embeds=torch.from_numpy(vis))
    assert fused.shape == (B, cfg.n_patches + PROMPT, cfg.vocab)
    assert not torch.allclose(fused[:, cfg.n_patches:], text)


def test_generate_counts_the_patches_against_max_len():
    cfg, params = _port(PIXTRAL)
    toks, vis = _inputs(cfg)
    with pytest.raises(ValueError, match="8 patches"):
        serve.generate(cfg, params, toks, 14, PROMPT + 13,
                       vision_embeds=torch.from_numpy(vis))
    with pytest.raises(ValueError, match="no vision frontend"):
        mcfg, mparams = _port(MUSICGEN)
        serve.generate(mcfg, mparams, toks, 2, MAX_LEN,
                       vision_embeds=torch.from_numpy(vis))
    with pytest.raises(ValueError, match="decode step"):
        caches = TM.init_caches(cfg, B, MAX_LEN, device="cpu")
        TM.forward(cfg, params, torch.from_numpy(toks[:, :1]), mode="decode",
                   caches=caches, pos=20, vision_embeds=torch.from_numpy(vis))


@pytest.mark.parametrize("name", FRONTENDS)
def test_full_width_layout_matches_jax(name):
    want = jax.eval_shape(lambda k: JM.init_params(jget_arch(name), k),
                          jax.random.PRNGKey(0))
    want = {n: tuple(s.shape) for n, s in convert.flatten(want).items()}
    got = convert.param_shapes(get_arch(name))
    assert got == want
    assert ("vision_proj" in got) == (name != MUSICGEN)
    if name == PIXTRAL:
        assert got["vision_proj"] == (5120, 5120)


# --- training with the vision stub -------------------------------------------

def _batch(cfg, seed=0, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (4, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (4, s)).astype(np.int32)
    labels[rng.random((4, s)) < 0.1] = -1
    vis = rng.normal(0, 1, (4, cfg.n_patches, cfg.d_model)) \
        .astype(np.float32)
    return toks, labels, vis


@functools.lru_cache(maxsize=None)
def _train_trajectories(name):
    """Two steps of each package's ``train_step`` on a batch with patch
    embeddings, from the same parameters: metrics and parameters after
    each, as numpy."""
    jcfg, tcfg = jget_arch(name).smoke(), get_arch(name).smoke()
    jtc = JT.TrainConfig(optimizer=JAdamWConfig(
        lr=1e-3, weight_decay=0.1, schedule=jwarmup_cosine(1e-3, 1, 2)),
        remat=False)
    ttc = TT.TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, weight_decay=0.1, schedule=warmup_cosine(1e-3, 1, 2)),
        remat=False)
    js = JT.init_state(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, js.params),
                                     tcfg, device="cpu")
    ts = TT.TrainState(params, adamw_init(params))
    toks, labels, vis = _batch(tcfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "vision_embeds": jnp.asarray(vis)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long(),
          "vision_embeds": torch.from_numpy(vis)}
    jstep = jax.jit(lambda s, b: JT.train_step(jcfg, jtc, s, b))
    out = []
    for _ in range(2):
        js, jm = jstep(js, jb)
        ts, tm = TT.train_step(tcfg, ttc, ts, tb)
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()},
                    [np.asarray(x) for x in jax.tree.leaves(js.params)],
                    [x.numpy() for x in tree_leaves(ts.params)]))
    return out, int((labels >= 0).sum())


@pytest.mark.parametrize("step", [1, 2])
def test_vision_train_step_matches_jax(step):
    out, n_text = _train_trajectories(PIXTRAL)
    jm, tm, jleaves, tleaves = out[step - 1]
    assert tm["n_tok"] == jm["n_tok"] == n_text     # patches carry no loss
    for key in ("loss", "ce", "grad_norm"):
        assert tm[key] == pytest.approx(jm[key], rel=1e-5), key
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ce_chunk", [0, 8])
@pytest.mark.parametrize("name", [PIXTRAL, LLAMA4])
def test_vision_loss_fn_matches_jax(name, ce_chunk):
    """Both cross-entropy paths, the chunked one with a ragged last chunk
    (Np + S = 8 + 12 positions in chunks of 8)."""
    jcfg, tcfg = jget_arch(name).smoke(), get_arch(name).smoke()
    _, _, jp = _reference(name)
    tp = convert.params_from_jax(jp, tcfg, device="cpu")
    toks, labels, vis = _batch(tcfg, seed=1, s=12)
    jtc = JT.TrainConfig(ce_chunk=ce_chunk, remat=False)
    ttc = TT.TrainConfig(ce_chunk=ce_chunk, remat=False)
    jl, jm = JT.loss_fn(jcfg, jtc, jax.tree.map(jnp.asarray, jp), {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "vision_embeds": jnp.asarray(vis)})
    with torch.no_grad():
        tl, tm = TT.loss_fn(tcfg, ttc, tp, {
            "tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long(),
            "vision_embeds": torch.from_numpy(vis)})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for key in ("ce", "aux", "n_tok"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                               abs=1e-7), key
    assert float(tm["n_tok"]) == float((labels >= 0).sum())
