"""Pod-compressed training (``repro_torch.train.pod_compress``) against the
JAX package, on the CPU, and ``examples/torch_compressed_dp.py``.

The reference's own ``pod_compressed_train_step`` does not run on JAX 0.9.0
(``repro.compat.shard_map`` has no ``axis_names``), so the reference here is
its step body composed by hand as a fully manual ``shard_map`` over a
("pod",) mesh of 4 forced host devices, under ``jit``: JAX's
``train_step`` with ``compressed_grad_allreduce``'s mean as its
``grad_transform`` and ``pmean`` of the loss (``pod_compress.py:49-58``
with a data axis of one).  It runs once, in a subprocess, and writes its
initial parameters first (so the port's 4 gloo ranks start while it
compiles), then its reduced step-1 gradients, losses and parameters.

Tolerances, with their reasons:
  * step-1 loss rtol 1e-6: the same parameters and batch, fp32 sums in
    another order;
  * reduced gradients: equal but where a rank's gradient, a few ulps off
    JAX's, lands on the other side of an int8 rounding boundary, which
    moves the reduced element by one code step: at most 0.1% of the
    elements, each within one step of its leaf (max |mean| / 127, plus
    rtol 1e-5 for the unquantized arithmetic);
  * parameters after 2 steps: AdamW moves an element by about lr x
    m / sqrt(v), so an element whose reduced gradient differs by a code
    step (where m and v are themselves tiny) can part by up to ~2 lr a
    step: max |diff| <= 4 lr over 2 steps, and all but 0.1% of the
    elements within 1e-6 + 1e-5 x |p|.
"""
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

SEQ, BATCH, LR, STEPS = 32, 8, 2e-3, 2
PODS = 4

JAX_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_arch
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.train import train_step as JT
from repro.train.collectives import compressed_grad_allreduce
from repro.train.optimizer import AdamWConfig

SEQ, BATCH, LR, STEPS = (int(sys.argv[2]), int(sys.argv[3]),
                         float(sys.argv[4]), int(sys.argv[5]))
out_dir = sys.argv[1]

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out

cfg = get_arch("gemma3-1b").smoke()
tc = JT.TrainConfig(optimizer=AdamWConfig(lr=LR, weight_decay=0.1),
                    remat=False)
state = JT.init_state(cfg, jax.random.PRNGKey(0))
np.savez(os.path.join(out_dir, "p0.tmp.npz"), **flat(state.params))
os.rename(os.path.join(out_dir, "p0.tmp.npz"), os.path.join(out_dir, "p0.npz"))

mesh = make_mesh((4,), ("pod",))

def body(state, batch):
    seen = {}

    def transform(g):        # the reduced gradients leave as an output too
        seen["mean"] = compressed_grad_allreduce(g, "pod")[0]
        return seen["mean"]

    new, met = JT.train_step(cfg, tc, state, batch, grad_transform=transform)
    return new, jax.lax.pmean(met["loss"], "pod"), met["grad_norm"], seen["mean"]

rep = jax.tree.map(lambda _: P(), state)
step = jax.jit(shard_map(body, mesh=mesh, in_specs=(rep, P("pod")),
                         out_specs=(rep, P(), P(), rep.params),
                         check_vma=False))
data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                              global_batch=BATCH, mean_doc_len=SEQ / 2))
out = {}
for i in range(STEPS):
    batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
    state, loss, gnorm, mean = step(state, batch)
    out[f"loss{i}"], out[f"gnorm{i}"] = np.asarray(loss), np.asarray(gnorm)
    if i == 0:
        out.update({"g1/" + k: v for k, v in flat(mean).items()})
out.update({"p/" + k: v for k, v in flat(state.params).items()})
np.savez(os.path.join(out_dir, "ref.npz"), **out)
print("OK")
"""


def _unflatten(flat: dict, skeleton: dict) -> dict:
    """``{"a/b": leaf}`` as a nested dict with ``skeleton``'s empty dicts
    (which a flat name cannot carry)."""
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


def _setup(ref_dir):
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import convert
    from repro_torch.models.model import init_params
    from repro_torch.train import train_step as TT
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = get_arch("gemma3-1b").smoke()
    tc = TT.TrainConfig(optimizer=AdamWConfig(lr=LR, weight_decay=0.1),
                        remat=False)
    p0 = dict(np.load(os.path.join(ref_dir, "p0.npz")))
    params = convert.params_from_jax(
        _unflatten(p0, init_params(cfg, device="meta")), cfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, mean_doc_len=SEQ / 2))
    batches = [{k: torch.from_numpy(v) for k, v in data.batch(i).items()}
               for i in range(STEPS)]
    return cfg, tc, TT.TrainState(params, adamw_init(params)), batches


def _rank_pod(rank, world, ref_dir):
    from repro_torch.models.convert import flatten
    from repro_torch.train import pod_compress as PC
    from repro_torch.train import train_step as TT
    from repro_torch.train.collectives import compressed_grad_allreduce

    cfg, tc, state, batches = _setup(ref_dir)
    out = {}
    # (pod 4, data 1, model 1)
    mesh = Mesh(np.arange(4).reshape(4, 1, 1), ("pod", "data", "model"))
    step = PC.pod_compressed_train_step(cfg, tc, mesh)
    local = PC.shard_batch(batches[0], mesh)
    _, _, g = TT.loss_and_grads(cfg, tc, state.params, local)
    reduced = compressed_grad_allreduce(g, mesh.group("pod"))[0]
    out["g1"] = {k: v.numpy() for k, v in flatten(reduced).items()}
    st = state
    for i in range(STEPS):
        st, m = step(st, PC.shard_batch(batches[i], mesh))
        out[f"loss{i}"] = float(m["loss"])
        out[f"gnorm{i}"] = float(m["grad_norm"])
    out["p"] = {k: v.numpy() for k, v in flatten(st.params).items()}

    # (pod 2, data 2, model 1): the mean before the ring is the pod's
    # whole-batch gradient; the step keeps every rank's parameters equal
    mesh2 = Mesh(np.arange(4).reshape(2, 2, 1), ("pod", "data", "model"))
    step2 = PC.pod_compressed_train_step(cfg, tc, mesh2)
    local = PC.shard_batch(batches[0], mesh2)
    _, _, g = TT.loss_and_grads(cfg, tc, state.params, local)
    mean = PC.data_mean(g, local["labels"], mesh2.group("data"))
    half = BATCH // 2
    p = mesh2.axis_index("pod")
    pod_batch = {k: v[p * half:(p + 1) * half] for k, v in batches[0].items()}
    _, _, want = TT.loss_and_grads(cfg, tc, state.params, pod_batch)
    out["data_mean"] = {k: v.numpy() for k, v in flatten(mean).items()}
    out["pod_grad"] = {k: v.numpy() for k, v in flatten(want).items()}
    st2, m2 = step2(state, local)
    out["p_2x2"] = {k: v.numpy() for k, v in flatten(st2.params).items()}
    out["loss_2x2"] = float(m2["loss"])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(tmp), str(SEQ), str(BATCH),
         str(LR), str(STEPS)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=subproc_env(), cwd=".")
    try:
        deadline = time.monotonic() + 120
        while not (tmp / "p0.npz").exists():
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "no initial parameters"
            time.sleep(0.1)
        ranks = D.spawn_ranks(_rank_pod, PODS, args=(str(tmp),),
                              timeout=120, workdir=str(tmp))
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "OK" in stdout, stderr[-3000:]
    return dict(np.load(tmp / "ref.npz")), ranks


def test_step1_loss_matches_the_reference(results):
    ref, ranks = results
    for out in ranks:
        assert out["loss0"] == pytest.approx(float(ref["loss0"]), rel=1e-6)
        assert np.isfinite(out["loss1"]) and np.isfinite(out["gnorm1"])
        assert out["loss0"] == ranks[0]["loss0"]


def test_reduced_gradients_match_but_for_int8_code_steps(results):
    ref, ranks = results
    total = flips = 0
    for name, got in ranks[0]["g1"].items():
        want = ref["g1/" + name]
        step = np.abs(want).max() / 127.0
        diff = np.abs(got - want)
        off = diff > 1e-5 * np.abs(want) + 1e-12
        assert np.all(diff[off] <= step * (1 + 1e-5)), name
        total, flips = total + want.size, flips + int(off.sum())
        for out in ranks[1:]:
            assert np.array_equal(out["g1"][name], got)
    assert flips <= 1e-3 * total, (flips, total)


def test_parameters_after_two_steps_and_equal_on_every_rank(results):
    ref, ranks = results
    total = loose = 0
    for name, got in ranks[0]["p"].items():
        want = ref["p/" + name]
        diff = np.abs(got - want)
        assert diff.max() <= 4 * LR, name
        loose += int((diff > 1e-6 + 1e-5 * np.abs(want)).sum())
        total += want.size
        for out in ranks[1:]:
            assert np.array_equal(out["p"][name], got), name
    assert loose <= 1e-3 * total, (loose, total)


def test_inner_data_mean_is_the_pods_whole_batch_gradient(results):
    """(pod 2, data 2): the token-weighted mean over a pod's two data ranks
    equals the gradient of the pod's half of the batch, rtol 1e-5."""
    _, ranks = results
    for out in ranks:
        for name, want in out["pod_grad"].items():
            got = out["data_mean"][name]
            assert np.abs(got - want).max() <= 1e-5 * max(
                np.abs(want).max(), 1e-30), name
    for name, p in ranks[0]["p_2x2"].items():
        for out in ranks[1:]:
            assert np.array_equal(out["p_2x2"][name], p), name
    assert all(np.isfinite(out["loss_2x2"]) for out in ranks)
    assert len({out["loss_2x2"] for out in ranks}) == 1


def test_a_model_axis_raises_13f():
    from repro_torch.configs import get_arch
    from repro_torch.train import pod_compress as PC
    from repro_torch.train.train_step import TrainConfig

    mesh = Mesh(np.arange(4).reshape(1, 2, 2), ("pod", "data", "model"))
    with pytest.raises(NotImplementedError, match="13f"):
        PC.pod_compressed_train_step(get_arch("gemma3-1b").smoke(),
                                     TrainConfig(), mesh)


def test_example_trains_on_four_cpu_ranks():
    out = subprocess.run(
        [sys.executable, "examples/torch_compressed_dp.py", "--ranks", "4",
         "--device", "cpu"], capture_output=True, text=True,
        env=subproc_env(), cwd=".", timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = [float(l.split()[3]) for l in out.stdout.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 6 and np.all(np.isfinite(losses)), out.stdout
    assert "ranks' final parameters equal: True" in out.stdout, out.stdout
    assert "[example] OK" in out.stdout
