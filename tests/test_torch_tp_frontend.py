"""Tensor-parallel training of the frontend configs against the JAX
package's mesh step, on the CPU: pixtral-12b (``vision_proj``
column-parallel and gathered, patch embeddings on every data shard, one KV
head split inside the head at a 4-way axis) and musicgen-large (the audio
family, GELU MLP).  The machinery and the tolerances are
``test_torch_tensor_parallel.py``'s."""
import pytest

from test_torch_tensor_parallel import (MESHES, check_leaves, check_metrics,
                                        check_whole_leaves_equal, run_file)

FRONTEND = ("pixtral-12b", "musicgen-large")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_file(tmp_path_factory.mktemp("tp"), FRONTEND)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", FRONTEND)
def test_loss_and_grad_norm_match_the_reference_mesh_step(results, name,
                                                          shape):
    check_metrics(*results, name, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", FRONTEND)
def test_leaves_gathered_back_match_the_reference(results, name, shape):
    check_leaves(*results, name, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", FRONTEND)
def test_whole_leaves_are_bitwise_equal_on_every_rank(results, name, shape):
    check_whole_leaves_equal(results[1], name, shape)


def test_vision_proj_is_split_over_the_model_axis():
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.train_step import state_layout
    import numpy as np

    cfg = get_arch("pixtral-12b").smoke()
    specs = state_layout(cfg, Mesh(np.arange(4).reshape(1, 4),
                                   ("data", "model")))
    assert tuple(specs.params["vision_proj"]) == (None, "model")
    assert tuple(specs.params["embed"]) == ("model", None)
    assert tuple(specs.params["lm_head"]) == (None, "model")
