"""``--backbone rdnet --window 8`` (the 0031 row) through the tests of
``test_torch_backbone_driver.py``, at ``--data_shape 16``: the port's epoch
resumed by the JAX driver and the JAX epoch by the port, ``evaluate
--metrics_out`` as the trainer's final test, and ``train --save_feats``
(one 512-d clip feature a sample, at the paths the JAX driver writes)."""
import shutil

import pytest

from test_torch_backbone_driver import _one_torch_thread, root, run_chain  # noqa: F401
from test_torch_backbone_driver import \
    test_each_package_resumes_the_others_epoch, \
    test_evaluate_scores_as_the_final_test, \
    test_save_feats_writes_what_the_jax_driver_writes  # noqa: F401


@pytest.fixture(scope="module")
def chain(root, tmp_path_factory):  # noqa: F811
    """The chain's epoch files (~0.5 GB each: R(2+1)D-34's parameters and
    momentum) are removed after the module."""
    workdir = str(tmp_path_factory.mktemp("work"))
    yield run_chain("rdnet", root, workdir)
    shutil.rmtree(workdir)
