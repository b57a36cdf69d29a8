"""Elastic restore of a sharded train state, on the CPU: 4 gloo ranks
train gemma3-1b smoke (every leaf ZeRO'd or model-split somewhere) one
step on mesh (data 1, model 4) and save it (``checkpoint.save`` with
``shardings``: each leaf gathered whole, rank 0 writes the reference's
one-file layout); the same ranks restore it onto mesh (data 2, model 2)
(``restore(shardings=...)``), and this process restores it onto one device
and into the JAX package's own ``restore``.  Every leaf is bitwise the
saved one, and every rank's blocks are bitwise its ``local_slice`` of the
whole."""
import os

import numpy as np
import pytest
import torch

from repro_torch import distributed as D
from repro_torch.launch.mesh import Mesh

NAME = "gemma3-1b"


def _state(cfg):
    from repro_torch.train import train_step as TT
    return TT.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")


def rank_main(rank, world, ckpt):
    from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                                   flatten_with_keys,
                                                   restore, save)
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.shardings import (batch_specs, gather_params,
                                              local_slice, shard_params,
                                              to_shardings)
    from repro_torch.train import train_step as TT

    cfg = get_arch(NAME).smoke()
    a = Mesh(np.arange(4).reshape(1, 4), ("data", "model"))
    b = Mesh(np.arange(4).reshape(2, 2)[::-1], ("data", "model"))
    specs_a, specs_b = TT.state_layout(cfg, a), TT.state_layout(cfg, b)
    state = shard_params(_state(cfg), specs_a, a, rank)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, mean_doc_len=16))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    bs = batch_specs(batch, a)
    state, _ = TT.train_step(cfg, TT.TrainConfig(remat=False), state,
                             {k: local_slice(v, bs[k], a, rank)
                              for k, v in batch.items()}, mesh=a,
                             specs=specs_a)
    saved = gather_params(state, specs_a, a)
    save(ckpt, 1, state, shardings=to_shardings(specs_a, a))
    # the async path too, one step later in the same directory
    ck = AsyncCheckpointer(ckpt)
    ck.save_async(2, state, shardings=to_shardings(specs_a, a))
    ck.wait()
    committed = os.path.exists(os.path.join(ckpt, "step_00000002",
                                            "COMMITTED"))
    template = shard_params(_state(cfg), specs_b, b, rank)
    restored, step = restore(ckpt, template, step=1,
                             shardings=to_shardings(specs_b, b))
    whole = gather_params(restored, specs_b, b)
    mine = flatten_with_keys(restored)
    want = flatten_with_keys(shard_params(saved, specs_b, b, rank))
    blocks_ok = all(torch.equal(mine[k], want[k]) for k in want)
    return {"step": step, "committed": committed, "blocks_ok": blocks_ok,
            "saved": {k: v.numpy() for k, v in
                      flatten_with_keys(saved).items()},
            "whole": {k: v.numpy() for k, v in
                      flatten_with_keys(whole).items()}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt = str(tmp / "ckpt")
    return ckpt, D.spawn_ranks(rank_main, 4, args=(ckpt,), timeout=180,
                               workdir=str(tmp))


def test_restore_onto_another_mesh_is_bitwise(results):
    _, ranks = results
    from repro_torch.configs import get_arch
    from repro_torch.models.convert import param_shapes

    saved = ranks[0]["saved"]
    n = len(param_shapes(get_arch(NAME).smoke()))
    assert len(saved) == 3 * n + 1          # params, mu, nu and the step
    for out in ranks:
        assert out["step"] == 1 and out["committed"] and out["blocks_ok"]
        assert out["saved"].keys() == saved.keys() == out["whole"].keys()
        for k, v in saved.items():
            assert np.array_equal(out["whole"][k], v), k
            assert np.array_equal(out["saved"][k], v), k


def test_restore_onto_one_device_is_bitwise(results):
    from repro_torch.checkpoint.checkpoint import flatten_with_keys, restore
    from repro_torch.configs import get_arch

    ckpt, ranks = results
    for step in (1, 2):
        got, at = restore(ckpt, _state(get_arch(NAME).smoke()), step=step)
        assert at == step
        got = flatten_with_keys(got)
        for k, v in ranks[0]["saved"].items():
            assert np.array_equal(got[k].numpy(), v), k


def test_the_reference_restores_the_sharded_save(results):
    """The one-file layout is the reference's: ``repro.checkpoint.restore``
    reads it into its own state, leaf for leaf."""
    import jax

    from repro.checkpoint.checkpoint import restore as jrestore
    from repro.configs import get_arch as jget_arch
    from repro.train import train_step as JT

    ckpt, ranks = results
    template = JT.init_state(jget_arch(NAME).smoke(), jax.random.PRNGKey(1))
    got, step = jrestore(ckpt, template, step=1)
    assert step == 1
    leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    saved = ranks[0]["saved"]
    assert len(leaves) == len(saved)
    for path, leaf in leaves:
        k = jax.tree_util.keystr(path)
        assert np.array_equal(np.asarray(leaf), saved[k]), k
