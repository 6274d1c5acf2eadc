"""Faults planted in the program underneath a run: each wraps one function
of ``gprf_torch`` so that the timed path is broken the way a wrong change
could break it.  The CPU tests and ``calibrate.py --fault`` plant them;
the benchmark's own runs never do."""

from __future__ import annotations

import contextlib
import importlib

import torch


def _frozen_runner(make):
    """Steps that return their state unchanged."""
    def inner(*args, **kwargs):
        init_fn, run_fn = make(*args, **kwargs)

        def frozen(carry):
            _, outs = run_fn(carry)
            return carry, outs
        return init_fn, frozen
    return inner


def _half_the_terms(fn):
    """Half of the pair terms and of the blocks' unary terms left out, the
    rest counted twice: the mean taken over the other half of the batch."""
    def inner(params, Y, assignment, mask, edges, unary_weights, pair_weights, *a, **kw):
        E, B = edges.shape[0] // 2, unary_weights.shape[-1]
        kept = torch.arange(B, device=unary_weights.device) < (B + 1) // 2
        unary = torch.where(kept, 2 * unary_weights, torch.zeros_like(unary_weights))
        return fn(params, Y, assignment, mask, edges[:E], unary, 2 * pair_weights[:E], *a, **kw)
    return inner


def _altered_value(fn):
    """Each evaluated value off by 1% where it is produced."""
    def inner(loss_fn, x):
        v, g = fn(loss_fn, x)
        return v + 1e-2 * v.abs(), g
    return inner


FAULTS = {
    "state_unchanged": ("gprf_torch.optim.lbfgs", "make_scan_lbfgs_runner", _frozen_runner),
    "half_the_batch": ("gprf_torch.model.fused", "gprf_ll_schur", _half_the_terms),
    "answer_altered": ("gprf_torch.optim.lbfgs", "value_and_grad", _altered_value),
}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted for the block."""
    module, attr, wrap = FAULTS[name]
    obj = importlib.import_module(module)
    orig = getattr(obj, attr)
    setattr(obj, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)
