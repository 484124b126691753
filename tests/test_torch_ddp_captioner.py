"""The captioning drivers on two gloo ranks on the CPU, on the synthetic
fixture with a 32-d feature store: ``train_gnmt --num_devices 2`` trains
an epoch (this process is rank 0, the other rank is spawned) and rank 0
alone writes the experiment; ``evaluate_gnmt --num_devices 2 --force``
decodes the test split sharded over the ranks and gives the
single-process evaluator's suite and ``--metrics_out``."""
import json
import os

import pytest
import torch

from fixtures import build_fixture
from test_torch_train_gnmt_driver import TRAIN, make_feature_store
from tennis_torch import evaluate_gnmt, train_gnmt
from tennis_torch.parallel.distributed import grouped


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def captioner(tmp_path_factory):
    root = build_fixture(tmp_path_factory.mktemp("cds"))
    make_feature_store(root, "tf")
    workdir = str(tmp_path_factory.mktemp("cwork"))
    old = os.getcwd()
    os.chdir(workdir)
    yield root, workdir
    os.chdir(old)


def test_captioner_trains_and_decodes_on_two_ranks(captioner):
    """``train_gnmt --num_devices 2`` trains an epoch on two gloo ranks
    (this process is rank 0) and rank 0 alone writes the experiment; then
    ``evaluate_gnmt --num_devices 2 --force`` decodes its test split
    sharded and gives the single-process evaluator's suite."""
    root, workdir = captioner
    argv = TRAIN + [f"--root={root}", "--model_id=m", "--epochs=1",
                    "--dropout=0", "--device=cpu"]
    state = train_gnmt.main(argv + ["--num_devices=2"])
    assert state.step > 0 and not grouped()
    exp = os.path.join(workdir, "models", "captioning", "experiments", "m")
    for name in ("0000.params", "scores.txt", "valid_best.params",
                 "best_test_out.txt", "epoch0_val_out.txt", "log.txt"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert len(open(os.path.join(exp, "scores.txt")).readlines()) == 1
    want = evaluate_gnmt.main(argv + ["--force", f"--metrics_out={workdir}/1.json"])
    got = evaluate_gnmt.main(argv + ["--force", "--num_devices=2",
                                     f"--metrics_out={workdir}/2.json"])
    assert got == want
    assert json.load(open(f"{workdir}/2.json")) == \
        json.load(open(f"{workdir}/1.json"))
