"""Expert-parallel training of moonshot-v1-16b-a3b (smoke: 8 experts,
top-2, a shared expert) against the JAX package's mesh step, on the CPU:
``moe_apply(mesh=...)`` routes every token on every model rank, runs the
rank's E / m experts and sums over the model group, as the reference's
``shard_map`` body does.  Routing is compared layer by layer: the router
probabilities of every MoE layer, recorded in both packages' mesh
forwards at each step's parameters, dispatch every data shard's tokens
(its own capacity) to the same expert ids and kept slots.  A token routed
otherwise is allowed only at a near tie (its k-th and (k+1)-th
probabilities within 1e-6 of the row's max), printed with its margin;
then the step's leaves are compared only where the routing agreed, as
``chip_smoke.py``'s (m-c) rule does.  Machinery and tolerances:
``test_torch_tensor_parallel.py``'s."""
import numpy as np
import pytest
import torch

from test_torch_tensor_parallel import (MESHES, STEPS, check_leaves,
                                        check_metrics,
                                        check_whole_leaves_equal, run_file)

MOONSHOT = "moonshot-v1-16b-a3b"
TIE = 1e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_file(tmp_path_factory.mktemp("tp"), (MOONSHOT,))


def _codes(probs: np.ndarray, shards: int):
    """(T, E) dispatch codes (0 unrouted, 1 dropped, 2 kept) of each data
    shard's rows routed with that shard's capacity, and the shards'
    (T,) k-th / (k+1)-th probability gaps over the row max."""
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import dispatch_codes

    cfg = get_arch(MOONSHOT).smoke()
    codes, gaps = [], []
    for part in np.split(probs, shards):
        p = torch.from_numpy(part)
        codes.append(dispatch_codes(p, cfg).numpy())
        top = p.topk(cfg.top_k + 1, dim=-1).values
        gaps.append(((top[:, cfg.top_k - 1] - top[:, cfg.top_k])
                     / top[:, 0]).numpy())
    return np.concatenate(codes), np.concatenate(gaps)


def _flips(results, shape):
    """[(step, layer, tokens routed otherwise, worst margin)]."""
    ref, ranks = results
    tag = "x".join(map(str, shape))
    out = []
    for i in range(STEPS):
        got = ranks[0][(MOONSHOT, shape)]["probs"][i]
        assert len(got) == 2                       # both layers are MoE
        for layer, p in enumerate(got):
            want = ref[MOONSHOT][f"{tag}/probs{i}/{layer}"]
            assert p.shape == want.shape
            assert np.abs(p - want).max() <= 1e-5
            a, gap = _codes(want, shape[0])
            b, _ = _codes(p, shape[0])
            off = (a != b).any(-1)
            if off.any():
                out.append((i, layer, int(off.sum()), float(gap[off].max())))
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_routing_is_identical_in_every_layer(results, shape):
    flips = _flips(results, shape)
    for step, layer, n, margin in flips:
        print(f"step {step} layer {layer}: {n} tokens routed otherwise, "
              f"router margin {margin:.3g} of the max probability")
        assert margin <= TIE, (step, layer, margin)
    assert not flips, flips


@pytest.mark.parametrize("shape", MESHES)
def test_loss_and_grad_norm_match_the_reference_mesh_step(results, shape):
    check_metrics(*results, MOONSHOT, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_leaves_gathered_back_match_the_reference(results, shape):
    if _flips(results, shape):
        pytest.fail("routing differs: leaves compared only where it agrees")
    check_leaves(*results, MOONSHOT, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_whole_leaves_are_bitwise_equal_on_every_rank(results, shape):
    """The router and the norms among them."""
    check_whole_leaves_equal(results[1], MOONSHOT, shape)
    whole = results[1][0][(MOONSHOT, shape)]["steps"][0]["whole"]
    assert any(k.endswith("moe/router") for k in whole)


@pytest.mark.parametrize("shape", MESHES)
def test_experts_are_split_over_the_model_axis(results, shape):
    """Each rank's mu holds its share: the experts' leaves are E / m."""
    for out in results[1]:
        run = out[(MOONSHOT, shape)]
        assert run["mu_elements"] == run["mu_want"]


def ep_layer_rank(rank, world, path, shape):
    """One MoE layer expert-parallel on this rank (``test_torch_moe.py``):
    its y, router probabilities and the gradients of sum(y dy) + aux with
    respect to its tokens, the router and its experts' w_gate (the last
    two summed over the data axis)."""
    from repro_torch import distributed as D
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.shardings import local_slice
    from repro_torch.models import moe
    from repro_torch.models.sharding import P

    cfg = get_arch(MOONSHOT).smoke()
    with np.load(path) as f:
        a = {k: torch.from_numpy(f[k]) for k in f.files}
    mesh = Mesh(np.arange(world).reshape(shape), ("data", "model"))
    experts, batch = P("model", None, None), P("data", None, None)
    p = {"router": a["router"].clone().requires_grad_()}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = local_slice(a[k], experts, mesh, rank).requires_grad_()
    x = local_slice(a["x"], batch, mesh, rank).requires_grad_()
    dy = local_slice(a["dy"], batch, mesh, rank)
    y, probs = moe.moe_apply(p, x, cfg, mesh=mesh)
    loss = (y * dy).sum() + moe.router_aux_loss(probs)
    gx, gr, gw = torch.autograd.grad(loss, (x, p["router"], p["w_gate"]))
    # each data shard's backward is its part of the weights' gradient
    data = mesh.group("data")
    gr, gw = D.psum(gr, data), D.psum(gw, data)
    return {k: v.detach().numpy() for k, v in dict(
        y=y, probs=probs, gx=gx, grouter=gr, gw_gate=gw).items()}
