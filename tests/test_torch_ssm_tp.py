"""Tensor-parallel Mamba1 / Mamba2 / hybrid layers over a ("data", "model")
mesh against the JAX package's mesh step, on the CPU: falcon-mamba-7b
(Mamba1, its d_inner channels split) and zamba2-7b (Mamba2 heads split,
the shared attention block tensor-parallel), served and trained, with the
machinery of ``test_torch_tp_serve.py`` (serving) and
``test_torch_tensor_parallel.py`` (training): one JAX subprocess runs both
references under ``jit`` with ``param_specs`` / ``cache_specs`` /
``batch_specs`` / ``state_specs`` shardings on 4 forced host devices, and
4 gloo ranks run the port from the reference's parameters.

Serving: falcon-mamba-7b on (1, 4), zamba2-7b on (1, 4) (fp32 and fp8
caches) and (2, 2), and :data:`VARIANTS`' zamba2-7b with 2 heads of 64
(the heads do not split over 4: the split leaves are gathered and its SSM
state is split over head_dim by ``cache_specs``).  The caches follow
``cache_specs`` as they are: every conv state and Mamba1's ``h`` stay
whole on every rank (a rank computes its channels and the leaves are
gathered after each step), Mamba2's ``h`` is split over its heads.
Training: 2 steps with remat from the reference's initial parameters on
falcon-mamba-7b and the variant on (1, 4), zamba2-7b on (1, 4) and (2,
2); the train step is what shows the backward of the dt / B / C products
and of the gate norm's statistic, which every rank uses whole and
differentiates for its own channels only (their collectives sum in both
directions).

Tolerances, with their reasons (those of the two machinery files):
  * logits within 1e-5 x max |logit| of the reference's, greedy tokens
    equal; caches gathered back within 1e-5 x max |leaf|; the fp8 case
    within ``test_torch_tp_serve.py``'s fp8 bound (codes one apart in at
    most 1 in 1000 bytes, 1e-4 x max |want|);
  * loss, ce, aux and grad norm: rel 1e-5; the first moment gathered back
    within 1e-4 x its max |want|; parameters gathered back after each step
    within 1e-4 x max(1, max |want|); leaves the specs leave whole equal on
    every rank, bitwise.  The variant's parameters are held so at every
    element whose first gradient is 0 or at least 10 x AdamW's eps (1e-8):
    its 2-head Mamba2 layers have elements of ``wz`` / ``wx`` /
    ``out_proj`` whose gradient is ~2e-9, within rounding of zero, where
    the step lr g / (|g| + eps) is set by the gradient's last bits (0.11 lr
    apart at worst); those elements are held by the first moment's bound.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import distributed as D

import test_torch_tensor_parallel as TP
import test_torch_tp_serve as TS

# zamba2-7b smoke with 2 heads of 64: d_inner 128 splits over 4, its heads
# do not; falcon-mamba-7b as itself, listed so that it trains on (1, 4)
# only (``test_torch_tensor_parallel.meshes``)
VARIANTS = {"zamba2-7b-h2": ("zamba2-7b", {"ssm_head_dim": 64}),
            "falcon-mamba-7b": ("falcon-mamba-7b", {})}
CASES = (
    ("falcon-mamba-7b", (1, 4), "fp32", 64),
    ("zamba2-7b", (1, 4), "fp32", 64),
    ("zamba2-7b", (1, 4), "fp8", 64),
    ("zamba2-7b", (2, 2), "fp32", 64),
    ("zamba2-7b-h2", (1, 4), "fp32", 64),
)
TRAIN = ("falcon-mamba-7b", "zamba2-7b", "zamba2-7b-h2")


def ssm_rank(rank, world, ref_dir, cases, train):
    """The serving cases, then 2 training steps of each of ``train`` on its
    meshes (``test_torch_tensor_parallel._port_run``)."""
    torch.use_deterministic_algorithms(True)
    TP.VARIANTS.update(VARIANTS)
    out = {TS.tag(c): TS.serve_case(c, ref_dir, rank, VARIANTS)
           for c in cases}
    for name in train:
        for shape in TP.meshes(name):
            out[(name, shape)] = TP._port_run(name, ref_dir, rank, shape)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ssm_tp"))
    code = os.path.join(tmp, "train_reference.py")
    with open(code, "w") as f:
        f.write(TP.JAX_CODE)
    variants = {**TP.VARIANTS, **VARIANTS}
    argv = [tmp, ",".join(TRAIN), str(TP.SEQ), str(TP.BATCH), str(TP.LR),
            str(TP.STEPS), json.dumps(variants), ""]
    proc = TS.start_reference(tmp, CASES, VARIANTS, train=(code, argv))
    try:
        ranks = D.spawn_ranks(ssm_rank, TS.RANKS,
                              args=(tmp, CASES, TRAIN), timeout=400,
                              workdir=tmp)
    finally:
        TS.wait_done(proc, timeout=400)
    serve = {TS.tag(c): TS._load(os.path.join(tmp, f"ref-{TS.tag(c)}.npz"))
             for c in CASES}
    train = {name: TS._load(os.path.join(tmp, f"ref-{name}.npz"))
             for name in TRAIN}
    return serve, train, ranks


@pytest.mark.parametrize("case", CASES, ids=TS.tag)
def test_logits_match_the_reference_mesh_step(results, case):
    TS.check_logits(results[0], results[2], case)


@pytest.mark.parametrize("case", CASES, ids=TS.tag)
def test_greedy_tokens_match_the_reference(results, case):
    TS.check_tokens(results[0], results[2], case)


@pytest.mark.parametrize("case", CASES, ids=TS.tag)
def test_caches_gathered_back_match_the_reference(results, case):
    TS.check_caches(results[0], results[2], case)


TRAIN_CASES = [(n, s) for n in TRAIN
               for s in (TP.MESHES[:1] if n in VARIANTS else TP.MESHES)]


def _id(case):
    return f"{case[0]}-{'x'.join(map(str, case[1]))}"


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_id)
def test_train_loss_and_grad_norm_match_the_reference(results, case):
    TP.check_metrics(results[1], results[2], *case)


EPS_FLOOR = 1e-7       # 10 x AdamW's eps


def check_leaves_off_eps(ref, ranks, name, shape):
    """``TP.check_leaves`` with each step's parameters held at the elements
    whose first gradient (10 x the first moment) is 0 (a row of the
    embedding no token reads) or at least :data:`EPS_FLOOR`."""
    ref, tag = ref[name], "x".join(map(str, shape))
    run = ranks[0][(name, shape)]
    for k, got in run["steps"][0]["mu"].items():
        want = ref[f"{tag}/mu0/{k}"]
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                      1e-30), (k, "mu")
    for i in range(TP.STEPS):
        for k, got in run["steps"][i]["p"].items():
            want = ref[f"{tag}/p{i}/{k}"]
            g = 10 * ref[f"{tag}/mu0/{k}"]
            held = (np.abs(g) >= EPS_FLOOR) | (g == 0)
            assert got.shape == want.shape, k
            assert np.abs(got - want)[held].max() <= 1e-4 * max(
                1.0, np.abs(want).max()), (k, i)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_id)
def test_train_leaves_gathered_back_match_the_reference(results, case):
    if case[0] in VARIANTS and case[0] != "falcon-mamba-7b":
        check_leaves_off_eps(results[1], results[2], *case)
    else:
        TP.check_leaves(results[1], results[2], *case)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_id)
def test_train_whole_leaves_are_bitwise_equal_on_every_rank(results, case):
    TP.check_whole_leaves_equal(results[2], *case)
