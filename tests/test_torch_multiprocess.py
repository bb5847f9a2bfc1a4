"""The port's multi-process training on the CPU: the train CLIs in two real processes over
gloo (``PANTO_COORDINATOR`` / ``PANTO_NUM_PROCESSES`` / ``PANTO_PROCESS_ID``, read by
``pantomatrix_tpu_torch/train/mesh.py:maybe_init_distributed``) against the same CLI in
one process on the same global batches, and ``entry.dryrun_multichip(2)``.

As in tests/test_multiprocess.py: SGD in float32, so that last-ulp differences of the
reduction order stay last-ulp (Adam's first steps are about sign(g) * lr and would turn
them into visible ones); EMAGE's losses to rtol 1e-5, parameters to atol 1e-6 / rtol
1e-5, and 2e-6 with FSDP. EMAGE runs with dropout 0.1, so the masks drawn at the global
shape are exercised; DisCo with two LSTM layers and dropout between them (its batch axis
is the second) and its all-pairs contrastive terms over the global batch.

DisCo is held at losses rtol 5e-5 and parameters atol 1e-5 / rtol 1e-5: its geodesic
term's arccos, clamped at 1 - 1e-6, turns last-ulp differences of the summation order
into gradient differences up to ~1e-3 relative (on tiny DisCo's first step, measured
against a float64 run of the same weights: 1.1e-4 for one float32 process, 6.5e-4 for
two; the contrastive terms alone agree to 4e-7), which after 4 steps at lr 3e-4 leaves
up to ~3e-6 in the weights and ~1e-5 in the logged losses. A fault of the gathered
terms or of the draws moves them by orders of magnitude more.

The runs, their data, bounds, launcher and comparison are ``tests/_torch_mp_runs.py``'s,
which chip_smoke.py phase 21b runs on the card. All runs start together in one fixture
(a few processes with one thread each), and a process still running at the runs' timeout
is killed: a hang fails the test with the process's log.
"""
import json
import os

import numpy as np
import pytest
import torch

import _torch_mp_runs as R
from _torch_mp_runs import EMAGE_ARGV

_exp, _metrics, _last_state = R.exp_dir, R.metrics, R.last_state


@pytest.fixture(scope="module")
def mp_beat2(tmp_path_factory):
    """tests/test_multiprocess.py's set (``_torch_mp_runs.write_data``)."""
    return R.write_data(tmp_path_factory.mktemp("mp_beat2_torch"))


@pytest.fixture(scope="module")
def cli_runs(mp_beat2, tmp_path_factory):
    """Every run of ``_torch_mp_runs.RUNS``, all started together: {name: [output dir of
    each rank]}."""
    train_meta, test_meta = mp_beat2
    data = [f"data.meta_paths=['{train_meta}']", f"data.test_meta_paths=['{test_meta}']"]
    try:
        return R.start_runs(R.RUNS, data, tmp_path_factory.mktemp("mp_runs"), "cpu")
    except RuntimeError as e:
        pytest.fail(str(e))


@pytest.mark.parametrize("name,atol,loss_rtol", [(n, R.BOUNDS[n][1], R.BOUNDS[n][0])
                                                 for n in ("emage_dp", "emage_fsdp", "disco_dp")])
def test_two_processes_train_as_one(cli_runs, name, atol, loss_rtol):
    single = cli_runs[name.split("_")[0] + "_single"][0]
    # losses, weights and iteration within the bounds; process 1 writes no checkpoint
    # and no metrics: process 0 writes them
    row = R.compare_runs(single, cli_runs[name], (loss_rtol, atol))
    assert row["iteration"] == 4
    assert any(k.startswith(("loss", "all")) for k in _metrics(single)[0])
    # the SGD optimizer state (and, under FSDP, its gathered form) loads into one card
    want, got = _last_state(single), _last_state(cli_runs[name][0])
    assert got["optimizer"]["scheduler"] == want["optimizer"]["scheduler"]


def test_emage_test_pass_runs_on_process_zero(cli_runs):
    rank0, rank1 = cli_runs["emage_dp"]
    path = os.path.join(_exp(rank0), "test_4", "metrics.json")
    assert json.load(open(path))["fgd_embedder"] == "stats"
    assert not os.path.exists(os.path.join(_exp(rank1), "test_4"))


def test_fsdp_checkpoint_loads_into_one_card(cli_runs):
    """The FSDP run's last/ directory is the whole model: from_pretrained on one process
    reads it, and its weights are the checkpoint's."""
    from pantomatrix_tpu_torch.models.api import AutoModel

    exp = _exp(cli_runs["emage_fsdp"][0])
    model = AutoModel.from_pretrained(os.path.join(exp, "ckpt", "last"), device="cpu")
    state = _last_state(cli_runs["emage_fsdp"][0])["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_dryrun_multichip_two_processes():
    from pantomatrix_tpu_torch.entry import dryrun_multichip

    result = dryrun_multichip(2, device="cpu")
    assert set(result) == {"train_dp", "train_fsdp", "inference_batch_sharded",
                           "inference_param_sharded"}
    for name, row in result.items():
        assert row["equal_to_one_process"], (name, row)


def test_dryrun_multichip_runs_on_the_card_by_default():
    """Like the other entry points it asks for the card, and raises where there is none."""
    import inspect

    from pantomatrix_tpu_torch.entry import dryrun_multichip

    assert inspect.signature(dryrun_multichip).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun_multichip(2)


def test_fsdp_resumes_a_one_card_checkpoint(cli_runs, mp_beat2, tmp_path):
    """The single-process run's last.bin resumed to step 6 by two FSDP processes (each
    loads it, then re-shards parameters and moments) and by one process: the same
    losses and weights, within the FSDP bounds."""
    train_meta, test_meta = mp_beat2
    last = os.path.join(_exp(cli_runs["emage_single"][0]), "ckpt", "last.bin")
    argv = [f"data.meta_paths=['{train_meta}']", f"data.test_meta_paths=['{test_meta}']",
            *[a for a in EMAGE_ARGV if a not in ("--evaluation", "solver.max_train_steps=4")],
            "solver.max_train_steps=6", "validation.test_steps=0",
            f"resume_from_checkpoint={last}"]
    R.start_runs({"single": ("train_emage", [], 1),
                  "fsdp": ("train_emage", ["solver.fsdp_model_axis=2"], 2)},
                 argv, tmp_path, "cpu")
    assert "at step 4" in open(tmp_path / "fsdp_0.log").read()
    single, fsdp = str(tmp_path / "single_0"), str(tmp_path / "fsdp_0")
    assert [x["step"] for x in _metrics(fsdp)] == [6]
    want, got = _last_state(single), _last_state(fsdp)
    assert got["iteration"] == want["iteration"] == 6
    for k, v in want["model"].items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), atol=2e-6, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(_metrics(fsdp)[0]["all"], _metrics(single)[0]["all"], rtol=1e-5)
