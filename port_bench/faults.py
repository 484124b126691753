"""Faults planted in the program under test, to show that ``correct``
catches them: each is a context manager that patches one function of
``tennis_torch`` for as long as it is open. ``calibrate.py`` reads them on
the card; the tests under ``tests/`` see each come out not correct.

- ``unchanged`` (train): the optimizer's update does nothing, so every
  step returns the state it was given.
- ``half_batch`` (train): the loss is the mean over the first half of the
  batch only.
- ``half_batch`` (extract): the second half of each batch's features are
  the first half's.
- ``altered`` (extract): the features of a batch's first two frames are
  delivered swapped.
"""
from __future__ import annotations

from port_bench.harness import patched as _patched

FAULTS = {"train": ("unchanged", "half_batch"),
          "extract": ("half_batch", "altered")}


def planted(kind: str, fault: str):
    """The context in which ``fault`` is planted for a cell of ``kind``."""
    if fault not in FAULTS.get(kind, ()):
        raise ValueError(f"no fault {fault!r} for the kind {kind!r}")
    if kind == "train":
        from tennis_torch.parallel import train_step as ts
        if fault == "unchanged":
            return _patched(ts.SGD, "update",
                            lambda self, params, grads, state: None)
        real = ts.make_train_step

        def half(logits, labels):
            n = logits.shape[0] // 2
            return ts.softmax_ce(logits[:n], labels[:n])

        return _patched(ts, "make_train_step",
                        lambda state, preprocess=None, rng_seed=0, **kw:
                        real(state, preprocess, rng_seed, loss_fn=half))
    from tennis_torch import inference
    real_extract = inference.make_extract_features

    def broken(model, device):
        extract = real_extract(model, device)

        def run(images):
            f = extract(images)
            if fault == "altered":
                return f[[1, 0] + list(range(2, f.shape[0]))]
            n = f.shape[0] // 2
            return f[:n].repeat(2, 1)[:f.shape[0]] if f.shape[0] % 2 == 0 \
                else f

        return run

    return _patched(inference, "make_extract_features", broken)
