"""The FLOP and byte counts, counted over the reference, equal the figures
the repository's card runs gave."""
import pytest

from port_bench import harness


def _cfg(bench, name):
    return harness.find_cell(bench, name).config


def test_densenet121_train_step_flops(bench):
    counts = harness.find_cell(bench, "densenet121-512.train.b64").counts()
    cfg = _cfg(bench, "densenet121-512.train.b64")
    assert counts.train_flops(cfg, 64) / 1e9 == pytest.approx(5604.95,
                                                              abs=0.005)


def test_r21d34_clip_forward_flops(bench):
    cell = harness.find_cell(bench, "r21d34-8x224.train.b64")
    assert cell.counts().forward_flops(cell.config, 1) / 1e9 == \
        pytest.approx(304.7, abs=0.05)
    assert cell.counts().train_flops(cell.config, 64) / 1e9 == \
        pytest.approx(58419.5, abs=0.05)


def test_dense_stack_bytes_and_bound(bench):
    cell = harness.find_cell(bench, "densenet121-512.extract.b64")
    work = cell.counts().dense_layer_work(cell.config, 64)
    assert len(work) == 58
    assert sum(b for _, b in work) / 1e9 == pytest.approx(6.82, abs=0.005)
    from port_bench import flops
    peaks = harness.peaks_of("NVIDIA H100 80GB HBM3")
    # the stack's totals are bytes-bound at 2.035 ms; layer by layer (each
    # launch waits on the one before) a few wide layers are bound by their
    # operations, and the least time is their sum
    total = flops.bound_s(sum(f for f, _ in work), sum(b for _, b in work),
                          peaks)
    assert total[1] == "bytes" and total[0] * 1e3 == pytest.approx(
        2.035, abs=0.001)
    bound = sum(flops.bound_s(f, b, peaks)[0] for f, b in work)
    assert bound * 1e3 == pytest.approx(2.1116, abs=0.0001)
