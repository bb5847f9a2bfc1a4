"""The port's mesh helpers (pantomatrix_tpu_torch/train/mesh.py) in one process, against
the JAX package's train/mesh.py: the FSDP placement rule over a set of shapes and
model-axis sizes, the mesh builders' errors on the same indivisible inputs (the port's
visible device count set to the JAX package's 8 virtual CPU devices; make_data_mesh's
multi-process check with jax.process_count() at 2), and maybe_init_distributed without
the launch variables."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from pantomatrix_tpu.train import mesh as jmesh
from pantomatrix_tpu_torch.train import mesh
from pantomatrix_tpu_torch.train.optim import make_optimizer

SHAPES = [(), (5,), (8,), (6, 4), (4, 6), (3, 5), (1024, 768, 3), (768, 256), (2, 2),
          (15, 16, 7), (1,), (9, 12)]


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fsdp_spec_matches_jax(shape, m):
    jm = JMesh(np.asarray(jax.devices()[:m]).reshape(1, m), ("data", "model"))
    want = tuple(jmesh.fsdp_spec(shape, jm, "model"))
    got = mesh.fsdp_spec(shape, mesh.Mesh(("data", "model"), (1, m)), "model")
    assert got == want
    assert mesh.fsdp_enabled(mesh.Mesh(("data", "model"), (8 // m, m))) == (m > 1)


def _error(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.fixture
def eight_devices(monkeypatch):
    assert len(jax.devices()) == 8
    monkeypatch.setattr(mesh, "_visible_devices", lambda: 8)


@pytest.mark.parametrize("batch,model_axis", [(8, 3), (6, 2), (8, 2), (4, 4), (12, 8),
                                              (10, 5), (16, 1)])
def test_make_train_mesh_errors_match_jax(eight_devices, batch, model_axis):
    want = _error(jmesh.make_train_mesh, batch, model_axis)
    got = _error(mesh.make_train_mesh, batch, model_axis)
    assert got == want
    if want is None:
        m = mesh.make_train_mesh(batch, model_axis)
        assert m.shape == dict(jmesh.make_train_mesh(batch, model_axis).shape)


@pytest.mark.parametrize("batch", [6, 7, 8, 16])
def test_make_data_mesh_errors_match_jax(eight_devices, monkeypatch, batch):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    assert _error(mesh.make_data_mesh, batch) == _error(jmesh.make_data_mesh, batch)


@pytest.mark.parametrize("n,names,sizes", [(9, ("data",), None), (8, ("data", "model"), (3, 2)),
                                           (8, ("data", "model"), (4, 2)), (8, ("data",), None)])
def test_make_mesh_errors_match_jax(eight_devices, n, names, sizes):
    want = _error(jmesh.make_mesh, n, names, sizes)
    assert _error(mesh.make_mesh, n, names, sizes) == want
    if want is None:
        assert mesh.make_mesh(n, names, sizes).shape == dict(jmesh.make_mesh(n, names, sizes).shape)


def test_mesh_coordinates_are_row_major():
    coords = [(mesh.Mesh(("data", "model"), (3, 2), rank=r).coord("data"),
               mesh.Mesh(("data", "model"), (3, 2), rank=r).coord("model")) for r in range(6)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]


def test_maybe_init_distributed_without_the_variables(monkeypatch):
    for k in ("PANTO_COORDINATOR", "PANTO_NUM_PROCESSES", "PANTO_PROCESS_ID",
              "PANTO_DISTRIBUTED", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_init_distributed("cpu") == (0, 1)
    assert not mesh.torch.distributed.is_initialized()
    m = mesh.make_train_mesh(8, 1)
    assert m.shape == {"data": 1} and not m.distributed and mesh.data_sharding(m) is None


def test_one_process_placement_is_the_identity():
    import torch

    model = torch.nn.Linear(4, 8)
    opt = make_optimizer(model.parameters(), learning_rate=0.5, max_grad_norm=1.0,
                         clip_parity="fixed")
    m = mesh.make_train_mesh(2)
    assert mesh.place_train_state(model, opt, m) == (model, opt)
    assert mesh.gather_replicated(model, opt, m) is opt and mesh.fsdp_state(opt) is None
    again = opt.like(model.parameters(), max_grad_norm=0.0)
    assert again.hparams == {**opt.hparams, "max_grad_norm": 0.0} and again.clip == 0.0


@pytest.mark.parametrize("cuda,world,rank,env,cards,want", [
    (False, 4, 3, {}, 0, ("gloo", None)),
    (False, 2, 1, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"}, 1, ("gloo", None)),
    # torchrun, one card a process, on one host and on the second of two
    (True, 4, 3, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"}, 4, ("nccl", 3)),
    (True, 8, 6, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "2"}, 4, ("nccl", 2)),
    # the launch states that this host's processes share its cards
    (True, 2, 1, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"}, 1, ("gloo", 0)),
    (True, 4, 3, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"}, 2, ("gloo", 1)),
    # PANTO_* without the local variables: no more processes than cards is one host
    (True, 2, 1, {}, 4, ("nccl", 1)),
    (True, 1, 0, {}, 1, ("nccl", 0)),
])
def test_backend_and_card(cuda, world, rank, env, cards, want):
    assert mesh.backend_and_card(cuda, world, rank, env, cards) == want


@pytest.mark.parametrize("world,env,cards,match", [
    (8, {}, 4, "LOCAL_WORLD_SIZE"),  # two hosts of 4, or 8 processes sharing 4 cards
    (2, {}, 1, "LOCAL_WORLD_SIZE"),
    (2, {"LOCAL_WORLD_SIZE": "2"}, 1, "LOCAL_RANK"),
    (2, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "0"}, 0, "CUDA is not available"),
])
def test_backend_and_card_refuses_a_guess(world, env, cards, match):
    with pytest.raises(RuntimeError, match=match):
        mesh.backend_and_card(True, world, 0, env, cards)
