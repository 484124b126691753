"""Training: the classifier's train step as the driver builds it
(``train.build_model``, ``create_train_state`` with SGD, momentum and
weight decay, ``make_train_step`` with ``train.make_preprocess``: the
device augment for frames, ``prepare_input`` for clips), fed by
``prefetch_to_device`` from a seeded host pool.

Each unit is a step: the next batch from the loader, then the step
enqueued; the window ends at a ``synchronize()``. Set-up builds the one
train state the window uses and drives it through its first
``warmup_steps`` steps through the same call and feed. The first three,
on pool slots 0, 1, 2 (rows that all differ), are what ``correct`` holds
against the reference: each step's loss, the norm of each leaf's first
gradient as the optimizer got it (its momentum trace after one step, less
the weight decay of the starting weights), the norm of each leaf's
change over the three steps, read before the fourth, and the logits the
first step returned.

Traffic keys: ``batch``, ``pool`` (distinct samples, a multiple of
``batch``), ``prefetch_buffer``, ``remat``, ``lr``, ``momentum``,
``wd``, ``warmup_steps`` (at least 3), ``traced_units``.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import harness

RATE = "train_samples_per_s"
CHECKED_STEPS = 3
# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone, and are left out of the leaf numbers
ZERO_GRAD = 1e-3


def _source(images, labels, batch: int):
    slots = len(images) // batch
    t = 0
    while True:
        k = t % slots
        rows = slice(k * batch, (k + 1) * batch)
        yield images[rows], labels[rows], np.arange(rows.start, rows.stop)
        t += 1


def driver_args(run):
    from tennis_torch import train as driver

    cfg, tr = run.cfg, run.traffic
    return driver.parse_args([
        "--backbone", cfg["backbone"], "--data_shape", str(cfg["data_shape"]),
        "--window", str(cfg.get("window", 1)), "--remat", tr["remat"],
        "--batch_size", str(tr["batch"]), "--lr", str(tr["lr"]),
        "--momentum", str(tr["momentum"]), "--wd", str(tr["wd"])])


def setup(run) -> None:
    from tennis_torch import train as driver
    from tennis_torch.data.loader import prefetch_to_device
    from tennis_torch.parallel import train_step as ts

    cfg, tr, st = run.cfg, run.traffic, run.state
    if tr["pool"] % tr["batch"] or tr["pool"] < CHECKED_STEPS * tr["batch"]:
        raise ValueError("the pool must hold whole batches, three at least")
    if tr["warmup_steps"] < CHECKED_STEPS:
        raise ValueError("set-up drives the three checked steps")
    args = driver_args(run)
    images, labels = run.pool(tr["pool"])
    run.mark("pool")
    model = harness.build_program_model(
        run, lambda: driver.build_model(args, cfg["num_classes"],
                                        dtype=harness.dtype_of(cfg)))
    tx, _ = ts.sgd_with_schedule(args.lr, args.momentum, args.wd, [],
                                 args.lr_factor, 1)
    state = ts.create_train_state(model, tx)
    st["state"] = state
    st["step"] = ts.make_train_step(state, driver.make_preprocess(
        args, model.dtype), rng_seed=run.seed)
    st["images"], st["labels"] = images, labels
    run.counters["prefetch"] = {}
    st["batches"] = prefetch_to_device(
        _source(images, labels, tr["batch"]), run.device,
        buffer_size=tr["prefetch_buffer"], stats=run.counters["prefetch"])
    harness.start_peak(run)
    run.mark("state")
    losses = []
    for k in range(tr["warmup_steps"]):
        unit(run)
        if k < CHECKED_STEPS:
            losses.append(float(st["loss"]))
        if k == 0:
            st["logits1"] = st["logits"].double().cpu()
            st["trace1"] = {n: t.detach().to("cpu", copy=True)
                            for n, t in state.opt_state.trace.items()}
        if k == CHECKED_STEPS - 1:
            st["p3"] = {n: p.detach().to("cpu", copy=True)
                        for n, p in model.named_parameters()}
    drain(run)
    st["losses"] = losses


def unit(run) -> None:
    st, spans = run.state, run.spans
    with spans("loader_wait"):
        images, labels, _ = next(st["batches"])
    with spans("step_enqueue"):
        st["loss"], st["logits"] = st["step"](images, labels)


def drain(run) -> None:
    with run.spans("synchronize"):
        if run.device.type == "cuda":
            torch.cuda.synchronize()
    if not math.isfinite(float(run.state["loss"])):
        run.counters["failed"] = run.counters.get("failed", 0) + 1


def flops_per_unit(run) -> int:
    return run.cell.counts().train_flops(run.cfg, run.traffic["batch"])


def release(run) -> None:
    st = run.state
    st["batches"].close()
    keep = {k: st[k] for k in ("images", "labels", "losses", "trace1", "p3",
                                "logits1")}
    st.clear()
    st.update(keep)


def program_readings(run) -> tuple:
    """(losses, {leaf: first gradient norm}, {leaf: change norm}, first
    logits) of the program's first three steps."""
    st, wd = run.state, run.traffic["wd"]
    g1, d3 = {}, {}
    for n, p0 in run.weights.items():
        if n not in st["p3"]:
            continue
        p0 = p0.double()
        g1[n] = float((st["trace1"][n].double() - wd * p0).norm())
        d3[n] = float((st["p3"][n].double() - p0).norm())
    return list(st["losses"]), g1, d3, st["logits1"]


def reference_readings(run, precision: str = "f32") -> tuple:
    """The same readings of the reference's three steps from the same
    weights, rows, labels and augment draws: the f32 train-mode forward,
    the loss, the gradients, SGD with momentum and weight decay."""
    from port_bench.reference import inputs
    from port_bench.reference.precision import strict_f32

    strict_f32()
    ref, cfg, tr = run.cell.reference(), run.cfg, run.traffic
    p = harness.reference_weights(run, trained=True)
    dt = next(iter(p.values())).dtype
    trained = {n: t for n, t in p.items() if t.requires_grad}
    start = {n: t.detach().clone() for n, t in trained.items()}
    trace = {n: torch.zeros_like(t) for n, t in trained.items()}
    b = tr["batch"]
    losses, g1, logits1 = [], {}, None
    for k in range(CHECKED_STEPS):
        u8 = torch.from_numpy(run.state["images"][k * b:(k + 1) * b]).to(
            run.device)
        y = torch.from_numpy(run.state["labels"][k * b:(k + 1) * b]).to(
            run.device)
        x = inputs.augment(u8, run.seed, k) if cfg.get("window", 1) == 1 \
            else inputs.prepare(u8)
        x = x.to(dt)
        logits = ref.logits(p, x, cfg, train=True, precision=precision,
                            remat=True)
        if k == 0:
            logits1 = logits.detach().double().cpu()
        loss = F.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, list(trained.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (n, t), g in zip(trained.items(), grads):
                if k == 0:
                    g1[n] = float(g.double().norm())
                trace[n].mul_(tr["momentum"]).add_(g + tr["wd"] * t)
                t.sub_(tr["lr"] * trace[n])
        del grads, loss, x, logits
    d3 = {n: float((t.detach().double() - start[n].double()).norm())
          for n, t in trained.items()}
    return losses, g1, d3, logits1


def compare(prog: tuple, ref: tuple, products=()) -> dict:
    """The numbers that decide ``correct``: ``logits_gap``, the widest
    relative L2 gap of a row of the first step's logits (the train-mode
    forward); ``loss_gap``, the widest relative gap of a step's loss;
    ``grad_gap`` and ``change_gap``, the median leaf's gap between the
    program's and the reference's norm (first gradient; change over three
    steps), each leaf's gap taken over the larger of its reference norm and
    the median leaf's, leaves with a reference gradient of round-off size
    left out; ``conv_grad_gap`` and ``conv_change_gap``, the same over the
    leaves in ``products`` (the kernels of convolutions and products)
    alone. The median and not the widest leaf: in bf16 the gradients of
    single BN scales and shifts, residues of sums that nearly cancel, read
    up to half the median leaf's norm off on every seed, where the program
    in f32 reads 1e-3. A cell's limits name the numbers it compares."""
    losses_p, g1_p, d3_p, logits_p = prog
    losses_r, g1_r, d3_r, logits_r = ref
    median = statistics.median(g1_r.values())
    keep = {n for n, v in g1_r.items() if v >= ZERO_GRAD * median}
    kernels = keep & set(products)
    return {"logits_gap": harness.row_gap(logits_p, logits_r),
            "loss_gap": max(harness.rel_gap(a, b)
                            for a, b in zip(losses_p, losses_r)),
            "grad_gap": harness.median_leaf_gap(g1_p, g1_r, keep),
            "change_gap": harness.median_leaf_gap(d3_p, d3_r, keep),
            "conv_grad_gap": harness.median_leaf_gap(g1_p, g1_r, kernels),
            "conv_change_gap": harness.median_leaf_gap(d3_p, d3_r, kernels)}


def check(run, precision: str | None = None) -> dict:
    """The program's three steps against the reference's; with
    ``precision``, the control: that precision's reference in the
    program's place."""
    if "reference" not in run.state:
        run.state["reference"] = reference_readings(run)
    ref = run.state["reference"]
    prog = program_readings(run) if precision is None else \
        reference_readings(run, precision)
    shapes = run.cell.reference().param_shapes(run.cfg)
    return compare(prog, ref, {n for n, (_, kind) in shapes.items()
                               if kind in ("conv", "linear")})
