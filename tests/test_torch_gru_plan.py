"""The async GRU kernel's partition and budget, on CPU.

``gru_plan`` mirrors ``csrc/gru_recurrence_async.cu``: which thread sums
which rows of which column of Wh, how many of them it keeps in registers and
in shared memory, and the CTA's shared memory. A numpy emulation of the
kernel's split sums over that partition (each thread's segment summed in k
order, then the segments in order, then the bias; each cluster's loop cut at
its rows' longest valid length) agrees with the Pallas kernel in interpret
mode.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tennis_tpu.ops.pallas.gru import gru_recurrence_pallas
from tennis_torch.ops import gru

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tennis_torch", "csrc")


def source_constants(name):
    with open(os.path.join(CSRC, name)) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}


@pytest.mark.parametrize("H", [32, 128, 256, 512])
@pytest.mark.parametrize("cluster", [8, 16])
def test_partition_covers_wh_once(cluster, H):
    """Every (row k, column) of Wh is summed by exactly one thread of one
    CTA; H = 512 takes clusters of 16 only (its slice at 8 CTAs is past
    the registers and shared memory of an SM)."""
    plan = gru.gru_plan(H, 4, cluster)
    if (cluster, H) == (8, 512):
        assert plan is None and gru.gru_plan(H, 4).cluster == 16
        return
    assert gru.gru_plan(H, 4).cluster == 16  # the measured default
    assert plan.cluster == cluster and plan.units == H // cluster
    assert plan.threads == plan.units * plan.segments
    count = np.zeros((H, 3 * H), np.int64)
    for rank, u, s, col, k0, n_reg, n_smem in gru.gru_partition(H, plan):
        assert 0 <= u < plan.units and 0 <= s < plan.segments
        assert n_reg + n_smem == H // plan.segments and k0 % 4 == 0
        count[k0:k0 + n_reg + n_smem, col] += 1
    np.testing.assert_array_equal(count, 1)
    # each CTA's columns are the r, z and n columns of its own units
    cols = {(rank, col) for rank, _, _, col, *_ in gru.gru_partition(H, plan)}
    for rank, col in cols:
        assert rank * plan.units <= col % H < (rank + 1) * plan.units


@pytest.mark.parametrize("H", [8, 32, 64, 128, 256, 368, 400, 480, 512])
@pytest.mark.parametrize("batch", [1, 4, 32])
def test_budget_and_source_constants(H, batch):
    """The plan fits 227 KiB of shared memory and 255 registers a thread,
    with the source's constants; rows per cluster keep every (row, unit)
    pair on its own thread."""
    k = source_constants("gru_recurrence_async.cu")
    assert (gru.ASYNC_MAX_THREADS, gru.ASYNC_MAX_ROWS, gru.REG_ROWS,
            gru.MAX_HIDDEN, gru.SMEM_LIMIT) == (
        k["kMaxThreads"], k["kMaxRows"], k["kRegL"], k["kMaxH"],
        k["kSmemLimit"])
    plan = gru.gru_plan(H, batch)
    assert plan is not None
    U, S, R = plan.units, plan.segments, plan.rows
    assert plan.threads <= k["kMaxThreads"] and R * U <= plan.threads
    assert R & (R - 1) == 0 and min(batch, k["kMaxRows"], S) <= R <= min(
        k["kMaxRows"], S)
    assert plan.reg_weights == 3 * min(H // S, k["kRegL"])
    # one CTA per SM: 65,536 registers over kMaxThreads threads leave 255 a
    # thread, which take the weights and the 3R accumulators
    assert 65536 // k["kMaxThreads"] >= 255 >= (
        3 * k["kRegL"] + 3 * k["kMaxRows"] + 4)
    # the source's Layout: h double-buffered, the partials, the staged
    # units, the weights past the registers
    def round4(n):
        return -(-n // 4) * 4

    want = 4 * (2 * R * H + round4(S * R * 3 * U) + round4(R * U)
                + plan.smem_weights * plan.threads)
    assert plan.smem_bytes == want <= 227 * 1024 - gru.STATIC_SMEM


def test_barrier_constants_and_limits():
    k = source_constants("gru_recurrence.cu")
    assert (gru.CLUSTER, gru.MAX_THREADS, gru.MAX_ROWS) == (
        k["kCluster"], k["kMaxThreads"], k["kMaxRows"])
    assert gru.barrier_fits(368, 8) and not gru.barrier_fits(376, 8)
    for H in (520, 1024, 12, 0):
        assert gru.gru_plan(H, 4) is None
        # the general kernel takes 520 and 12; no kernel 1024 or 0
        assert gru.gru_fits_smem(1, 4, H) == (0 < H < 1024)
    # the route: the async kernel wherever it takes H
    assert {gru.gru_route(128, B, H) for B in (1, 4, 32)
            for H in (32, 128, 256, 400, 512)} == {"async"}


def emulate(gx, h0, wh, bh, vl, plan):
    """The async kernel's arithmetic in numpy f32 over ``plan``'s partition."""
    T, B, _ = gx.shape
    H = h0.shape[1]
    S, L = plan.segments, H // plan.segments
    cols = np.zeros(3 * H, np.int64)
    for _, _, s, col, k0, *_ in gru.gru_partition(H, plan):
        assert k0 == s * L
        cols[col] += 1
    assert (cols == S).all()  # each column: S segments, in order below
    ys = np.zeros((T, B, H), np.float32)
    h_final = np.zeros((B, H), np.float32)
    for row0 in range(0, B, plan.rows):
        rows = np.arange(row0, min(B, row0 + plan.rows))
        t_end = max(min(max(int(vl[b]), 0), T) for b in rows)
        h = h0[rows].astype(np.float32)
        for t in range(t_end):
            part = np.zeros((S, len(rows), 3 * H), np.float32)
            for s in range(S):
                for k in range(s * L, (s + 1) * L):
                    part[s] = part[s] + h[:, k:k + 1] * wh[k]
            gh = np.zeros((len(rows), 3 * H), np.float32)
            for s in range(S):
                gh = gh + part[s]
            gh = gh + bh
            x = gx[t, rows]
            r = 1 / (1 + np.exp(-(x[:, :H] + gh[:, :H])))
            z = 1 / (1 + np.exp(-(x[:, H:2 * H] + gh[:, H:2 * H])))
            n = np.tanh(x[:, 2 * H:] + r * gh[:, 2 * H:])
            new = ((1 - z) * n + z * h).astype(np.float32)
            alive = (t < vl[rows])[:, None]
            h = np.where(alive, new, h)
            ys[t, rows] = np.where(alive, new, 0)
        h_final[rows] = h
    return ys, h_final


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, B, 3 * H)).astype(np.float32),
            (rng.normal(size=(B, H)) * 0.5).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("H,cluster", [(32, 8), (32, 16), (64, 16), (16, 8)])
@pytest.mark.parametrize("lengths", ["mixed", "all_zero", "all_short"])
def test_split_sums_match_pallas(H, cluster, lengths):
    """The emulation, at the kernel's own partition, and the port's CPU
    path agree with gru_recurrence_pallas(interpret=True); lengths that all
    end before T (all 0, or a longest row shorter than T) leave zeros and a
    frozen carry past them."""
    T, B = 7, 11
    gx, h0, wh, bh = _inputs(T, B, H, seed=H + cluster)
    vl = {"mixed": np.asarray([(0, 1, T // 2, T, T + 3)[i % 5] for i in range(B)]),
          "all_zero": np.zeros(B),
          "all_short": np.asarray([i % 5 for i in range(B)])}[lengths]
    vl = vl.astype(np.int32)
    plan = gru.gru_plan(H, B, cluster)
    ys_j, h_j = gru_recurrence_pallas(*map(jnp.asarray, (gx, h0, wh, bh, vl)),
                                      interpret=True)
    ys_e, h_e = emulate(gx, h0, wh, bh, vl, plan)
    np.testing.assert_allclose(ys_e, np.asarray(ys_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h_e, np.asarray(h_j), rtol=0, atol=1e-5)
    ys_t, h_t = gru.gru_recurrence(*map(torch.from_numpy, (gx, h0, wh, bh, vl)))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=1e-5)
    for b, n in enumerate(vl):
        assert not ys_e[max(n, 0):, b].any()
    if lengths == "all_zero":
        np.testing.assert_array_equal(h_e, h0)


def test_cpu_variants_run_the_plain_version():
    """On CPU tensors every variant runs the plain version and counts no
    launch; an unknown variant raises."""
    gx, h0, wh, bh = map(torch.from_numpy, _inputs(3, 2, 8, seed=0))
    want = gru.gru_recurrence_reference(gx, h0, wh, bh)
    before = (gru.gru_recurrence.launches, dict(gru.gru_recurrence.variant_launches))
    for variant in (None, *gru.VARIANTS):
        got = gru.gru_recurrence(gx, h0, wh, bh, variant=variant)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (gru.gru_recurrence.launches,
            gru.gru_recurrence.variant_launches) == before
    with pytest.raises(ValueError, match="variant"):
        gru.gru_recurrence(gx, h0, wh, bh, variant="scan")
