"""The pair pass's Gaussian conditional as one autograd Function
(``gprf_torch.model.objective.SchurConditional``) against the three autograd
nodes it replaces, and the split rule it shares with ``mvn_ll_split``;
float64 on the CPU, on the plain twins."""

import numpy as np
import pytest
import torch

from gprf_torch.model import objective as tobj
from gprf_torch.ops import mvn
from gprf_torch.ops import split_mvn as tsplit
from gprf_torch.utils import profiling
from gprf_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)
RTOL = 1e-12
F64 = dict(dtype=torch.float64)


def _composition(C, Yj, Bm, Zi):
    """The conditional as the pair pass composed it before the Function."""
    return C - Bm.mT @ Bm, Yj - Bm.mT @ Zi


class _Composition:
    """A stand-in for SchurConditional that runs the composition."""

    @staticmethod
    def apply(C, Yj, Bm, Zi, h):
        return _composition(C, Yj, Bm, Zi)


def _close(a, b, rtol=RTOL):
    a, b = a.detach(), b.detach()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
    assert err <= rtol, err


def _read(M, h):
    """The blocks of S that mvn_ll_split reads: S[:, :h] and S[h:, h:]."""
    return (M,) if h is None else (M[..., :, :h], M[..., h:, h:])


def _inputs(N, m, dy, seed):
    g = torch.Generator().manual_seed(seed)
    C = torch.randn(N, m, m, generator=g, **F64)
    C = C @ C.mT / m + torch.eye(m, **F64)
    return [C, torch.randn(N, m, dy, generator=g, **F64),
            torch.randn(N, m, m, generator=g, **F64) / m ** 0.5,
            torch.randn(N, m, dy, generator=g, **F64)]


@pytest.mark.parametrize("m", [24, 216], ids=["whole", "blocked"])
def test_schur_conditional_matches_the_composition(m):
    """S's read blocks, rhs and every input's gradient under a
    non-symmetric dS (zero where the split reads nothing, as its slices
    leave it) equal the composition's; the split rule decides the blocks."""
    dy = 50
    h = tsplit.mvn_split_width(m, dy, mvn.PLAIN_OPS)
    assert (h is None) == (m == 24) and h in (None, tsplit.split_point(m))
    leaves = [t.requires_grad_(True) for t in _inputs(3, m, dy, seed=m)]
    S, rhs = tobj.SchurConditional.apply(leaves[0].clone(), *leaves[1:], h)
    S_ref, rhs_ref = _composition(*leaves)
    for a, b in zip(_read(S, h), _read(S_ref, h)):
        _close(a, b)
    _close(rhs, rhs_ref)
    g = torch.Generator().manual_seed(1)
    dS = torch.randn(S.shape, generator=g, **F64)
    if h is not None:
        dS[:, :h, h:] = 0
    drhs = torch.randn(rhs.shape, generator=g, **F64)
    grads = torch.autograd.grad((S, rhs), leaves, (dS, drhs))
    grads_ref = torch.autograd.grad((S_ref, rhs_ref), leaves, (dS, drhs))
    for a, b in zip(grads, grads_ref):
        _close(a, b)


@pytest.mark.parametrize("h, every_block", [(None, True), (16, False), (16, True)],
                         ids=["whole", "blocked", "blocked_every_block"])
def test_schur_conditional_gradcheck(h, every_block):
    """torch.autograd.gradcheck of the Function (m 24, the blocked form
    split at h = split_point(24) = 16), each input in turn, with the other
    outputs' cotangents random and non-symmetric: on the blocks the split
    reads, and on every block of S, where the one above the diagonal keeps
    C's values and its cotangent reaches C alone."""
    assert h in (None, tsplit.split_point(24))
    leaves = [t.requires_grad_(True) for t in _inputs(2, 24, 3, seed=5)]

    def f(C, Yj, Bm, Zi):
        S, rhs = tobj.SchurConditional.apply(C.clone(), Yj, Bm, Zi, h)
        return (*((S,) if every_block else _read(S, h)), rhs)

    assert torch.autograd.gradcheck(f, leaves, eps=1e-6, atol=1e-8, rtol=1e-6)


def test_schur_conditional_needs_only_the_gradients_asked_for():
    """An input that needs no gradient gets None, and its product is not
    run; the others are the composition's."""
    C, Yj, Bm, Zi = _inputs(2, 24, 3, seed=7)
    Bm.requires_grad_(True)
    S, rhs = tobj.SchurConditional.apply(C.clone(), Yj, Bm, Zi, None)
    (gB,) = torch.autograd.grad((S, rhs), Bm, (torch.ones_like(S), torch.ones_like(rhs)))
    S_ref, rhs_ref = _composition(C, Yj, Bm, Zi)
    (gB_ref,) = torch.autograd.grad((S_ref, rhs_ref), Bm,
                                    (torch.ones_like(S), torch.ones_like(rhs)))
    _close(gB, gB_ref)


@pytest.mark.parametrize("caps", [True, False], ids=["kernel_caps", "no_caps"])
def test_split_width_is_mvn_ll_splits(caps):
    """mvn_split_width and mvn_ll_split agree on h across m 8-480 and dy
    1-256: the width of the first leaf mvn_ll_split calls is h (K1 on the
    upper block, whole up to 240) where it splits, and m at K2 where it does
    not.  Leaves without caps take every width whole."""
    calls = []

    def chol_inv(K):
        calls.append(("chol_inv", K.shape[-1]))
        return K, K

    def mvn_ll(Kp, Ym, n_active):
        calls.append(("mvn_ll", Kp.shape[-1]))
        return n_active

    ops = mvn.PLAIN_OPS._replace(chol_inv=chol_inv, mvn_ll=mvn_ll, leaf_caps=caps)
    for dy in (1, 2, 5, 16, 49, 50, 64, 100, 128, 200, 256):
        for m in range(8, 481):
            calls.clear()
            tsplit.mvn_ll_split(torch.zeros(0, m, m, **F64), torch.zeros(0, m, dy, **F64),
                                torch.zeros(0, **F64), ops=ops)
            h = tsplit.mvn_split_width(m, dy, ops)
            assert calls[0] == (("mvn_ll", m) if h is None else ("chol_inv", h)), (m, dy)
            assert (h is None) == (not caps or m <= mvn.mvn_max_m(dy))


def _three_blocks(m, dy):
    """Three blocks of width m (m, m - 8 and m - 16 points) and two edges."""
    rng = np.random.default_rng(m)
    n_active = [m, m - 8, m - 16]
    X = rng.uniform(size=(sum(n_active), 2))
    Y = torch.as_tensor(rng.normal(size=(sum(n_active), dy)))
    assignment = torch.zeros((3, m), dtype=torch.int64)
    mask = torch.zeros((3, m), dtype=torch.bool)
    start = 0
    for b, n in enumerate(n_active):
        assignment[b, :n] = torch.arange(start, start + n)
        mask[b, :n] = True
        start += n
    p = params_from_numpy(X, [1.0], [0.1, 0.1], 0.1, device="cpu", dtype=torch.float64)
    return p, Y, assignment, mask, torch.tensor([[0, 1], [1, 2]])


@pytest.mark.parametrize("pair_chunk", [None, 1], ids=["whole_pass", "chunked"])
@pytest.mark.parametrize("m", [24, 216], ids=["whole", "blocked"])
def test_schur_ll_matches_the_composition(monkeypatch, m, pair_chunk):
    """_schur_ll's loss and X gradient through the Function equal the same
    loss through the composition it replaced, at a width where the pair
    pass builds S whole (24) and where it builds the split's blocks (216 at
    dy 50), with the whole pass and in chunks under remat; the counter
    counts the chunks built in blocks."""
    p, Y, assignment, mask, edges = _three_blocks(m, 50)
    p.X.requires_grad_(True)
    weights = (torch.tensor([0.0, -1.0, 0.0], **F64), torch.ones(2, **F64))

    def value_and_grad():
        profiling.fit_counts.update(pair_passes=0, pair_chunks=0, pair_schur_blocked=0)
        ll = tobj.gprf_ll_schur(p, Y, assignment, mask, edges, *weights, ops=mvn.PLAIN_OPS,
                                pair_chunk=pair_chunk)
        counts = {k: profiling.fit_counts[k] for k in ("pair_chunks", "pair_schur_blocked")}
        return ll.detach(), torch.autograd.grad(ll, p.X)[0], counts

    ll, gX, counts = value_and_grad()
    monkeypatch.setattr(tobj, "SchurConditional", _Composition)
    ll_ref, gX_ref, _ = value_and_grad()
    _close(ll, ll_ref)
    _close(gX, gX_ref)
    chunks = 1 if pair_chunk is None else 2
    assert counts == dict(pair_chunks=chunks, pair_schur_blocked=chunks if m == 216 else 0)


@pytest.mark.parametrize("m", [24, 216], ids=["whole", "blocked"])
def test_schur_ll_replicas_batched_match_each_alone(m):
    """Three replicas (their own points and hyperparameters) folded into one
    batch through the Function give each replica's loss and X gradient as
    it gives them alone, whole and where S is built in blocks."""
    p, Y, assignment, mask, edges = _three_blocks(m, 50)
    rng = np.random.default_rng(3)
    R = 3
    X = (p.X[None] + 0.01 * torch.as_tensor(rng.normal(size=(R, *p.X.shape)))).requires_grad_(True)
    hyper = dict(wfn_params=torch.tensor([[1.0], [1.2], [0.8]], **F64),
                 dfn_params=torch.tensor([[0.1, 0.1], [0.12, 0.09], [0.08, 0.11]], **F64),
                 noise_var=torch.tensor([0.1, 0.12, 0.08], **F64))
    weights = (torch.tensor([0.0, -1.0, 0.0], **F64), torch.ones(2, **F64))
    batched = tobj.GPRFParams(X=X, **hyper)
    ll = tobj.gprf_ll_schur(batched, Y, assignment.expand(R, -1, -1), mask.expand(R, -1, -1),
                            edges, *weights, ops=mvn.PLAIN_OPS)
    (gX,) = torch.autograd.grad(ll.sum(), X)
    for r in range(R):
        x = X[r].detach().requires_grad_(True)
        one = tobj.GPRFParams(X=x, **{k: v[r] for k, v in hyper.items()})
        ll1 = tobj.gprf_ll_schur(one, Y, assignment, mask, edges, *weights, ops=mvn.PLAIN_OPS)
        _close(ll[r], ll1)
        _close(gX[r], torch.autograd.grad(ll1, x)[0])


def test_multistart_runner_through_the_blocked_conditional_matches_single_starts():
    """The replica-batched L-BFGS runner over a loss whose pair pass builds
    S in the split's blocks (m 216 at dy 50) takes, for each replica, the
    steps its start takes alone: float64 values and points after four
    steps, batched against single starts."""
    from gprf_torch.optim import lbfgs as tlbfgs

    p, Y, assignment, mask, edges = _three_blocks(216, 50)
    weights = (torch.tensor([0.0, -1.0, 0.0], **F64), torch.ones(2, **F64))
    hyper = dict(wfn_params=p.wfn_params, dfn_params=p.dfn_params, noise_var=p.noise_var)
    shape = p.X.shape

    def loss(x):
        batch = x.shape[:-1]
        one = tobj.GPRFParams(X=x.view(*batch, *shape),
                              **{k: v.expand(batch + v.shape) for k, v in hyper.items()})
        return -tobj.gprf_ll_schur(one, Y, assignment.expand(*batch, -1, -1),
                                   mask.expand(*batch, -1, -1), edges, *weights,
                                   ops=mvn.PLAIN_OPS)

    rng = np.random.default_rng(7)
    x0s = p.X.reshape(1, -1) + 0.01 * torch.as_tensor(rng.normal(size=(3, p.X.numel())))
    profiling.fit_counts.update(pair_schur_blocked=0)
    init, run = tlbfgs.make_multistart_runner(loss, 4)
    carry, (values, _, _) = run(init(x0s))
    assert profiling.fit_counts["pair_schur_blocked"] == 5
    init1, run1 = tlbfgs.make_scan_lbfgs_runner(loss, 4)
    for r in range(3):
        one, (v1, _, _) = run1(init1(x0s[r]))
        _close(values[r], v1)
        _close(carry["x"][r], one["x"], rtol=1e-10)
