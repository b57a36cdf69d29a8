"""The port's checkpoints against the JAX package's, on the CPU: the same
layout and leaf keys, so that a training state written by either package
restores into the other bit for bit; a torn ``.tmp`` is ignored and the
async writer keeps the newest three."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jck
from repro.configs import get_arch as jget_arch
from repro.train import train_step as JT

from repro_torch.checkpoint import checkpoint as tck
from repro_torch.configs import get_arch
from repro_torch.models import convert
from repro_torch.train import train_step as TT
from repro_torch.train.optimizer import AdamWState, adamw_init, tree_leaves


def _states(name="granite-8b"):
    """A JAX TrainState one step in (so mu, nu and step are not zero) and
    the port's state with the JAX parameters carried over (zero moments)."""
    jcfg, tcfg = jget_arch(name).smoke(), get_arch(name).smoke()
    js = JT.init_state(jcfg, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 16)), jnp.int32)
    js, _ = JT.train_step(jcfg, JT.TrainConfig(remat=False), js,
                          {"tokens": toks, "labels": toks})
    params = convert.params_from_jax(jax.tree.map(np.asarray, js.params),
                                     tcfg, device="cpu")
    return js, TT.TrainState(params, adamw_init(params))


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _tleaves(state):
    return [x.numpy() for x in tree_leaves(state.params)] + \
        [state.opt.step.numpy()] + \
        [x.numpy() for t in (state.opt.mu, state.opt.nu)
         for x in tree_leaves(t)]


def test_leaf_keys_are_the_jax_keystrs():
    js, ts = _states()
    want = list(jck._flatten(js)[0])
    got = list(tck.flatten_with_keys(ts))
    assert got == want
    assert "[<flat index 0>]['blocks']['pos0']['attn']['wq']" in got
    assert "[<flat index 1>].step" in got
    assert "[<flat index 1>].mu['embed']" in got


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    js, ts = _states()
    jck.save(str(tmp_path), 1, js)
    got, step = tck.restore(str(tmp_path), ts)
    assert step == 1 and isinstance(got, TT.TrainState)
    assert isinstance(got.opt, AdamWState)
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 1
    for a, b in zip(_tleaves(got), _jleaves(js)):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_into_jax(tmp_path):
    js, ts = _states()
    ck = tck.AsyncCheckpointer(str(tmp_path))
    ck.save_async(4, ts, meta={"arch": "granite-8b-smoke"})
    ck.wait()
    assert ck.last_committed.endswith("step_00000004")
    names = sorted(os.listdir(ck.last_committed))
    assert names == ["COMMITTED", "manifest.json", "shard_0.npz"]
    with open(os.path.join(ck.last_committed, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 4 and manifest["n_hosts"] == 1
    assert manifest["meta"] == {"arch": "granite-8b-smoke"}
    got, step = jck.restore(str(tmp_path), js)
    assert step == 4
    for a, b in zip(_jleaves(got), _tleaves(ts)):
        np.testing.assert_array_equal(a, b)


def test_torn_checkpoint_ignored_keep_three_and_shape_check(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "l": [torch.zeros(2), torch.full((1,), 3.0)]}
    d = str(tmp_path)
    tck.save(d, 1, tree)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))     # torn: no marker
    ck = tck.AsyncCheckpointer(d)                         # keep=3
    for s in (2, 3, 4, 5):
        ck.save_async(s, tree)
    ck.wait()
    assert tck.latest_steps(d) == [3, 4, 5]
    assert os.path.isdir(os.path.join(d, "step_00000009.tmp"))
    got, step = tck.restore(d, tree)
    assert step == 5 and got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert all(torch.equal(x, y) for x, y in zip(got["l"], tree["l"]))
    old, step = tck.restore(d, tree, step=3)
    assert step == 3 and torch.equal(old["a"], tree["a"])
    bad = {"a": torch.zeros(3, 3), "b": {"c": torch.ones(4)},
           "l": tree["l"]}
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.restore(d, bad)
    with pytest.raises(ValueError, match="missing"):
        tck.restore(d, {"z": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), tree)


def test_async_save_snapshots_before_the_caller_moves_on(tmp_path):
    """The snapshot is taken in ``save_async``: updating the tensors right
    after does not change what is written."""
    tree = {"w": torch.ones(1000)}
    ck = tck.AsyncCheckpointer(str(tmp_path))
    ck.save_async(1, tree)
    tree["w"].mul_(7.0)
    ck.wait()
    got, _ = tck.restore(str(tmp_path), {"w": torch.zeros(1000)})
    assert torch.equal(got["w"], torch.ones(1000))


def test_moe_state_round_trips_across_packages(tmp_path):
    """An MoE training state (moonshot smoke: router, experts, shared
    expert) written by either package restores into the other bitwise."""
    js, ts = _states("moonshot-v1-16b-a3b")
    keys = list(tck.flatten_with_keys(ts))
    assert keys == list(jck._flatten(js)[0])
    assert "[<flat index 0>]['blocks']['pos0']['moe']['router']" in keys
    jck.save(str(tmp_path / "j"), 1, js)
    got, step = tck.restore(str(tmp_path / "j"), ts)
    assert step == 1 and got.opt.step.shape == ()      # a 0-d counter
    for a, b in zip(_tleaves(got), _jleaves(js)):
        np.testing.assert_array_equal(a, b)
    tck.save(str(tmp_path / "t"), 2, got)
    back, step = jck.restore(str(tmp_path / "t"), js)
    assert step == 2
    for a, b in zip(_jleaves(back), _jleaves(js)):
        np.testing.assert_array_equal(a, b)
