"""chip_smoke.py's step walk at the ReLU gates and clip branches, on the CPU.

Where a row's pre-activation lies within float32 rounding of a ReLU gate,
or (K4) its probability ratio within rounding of a clip edge, any float32
step of the update phase may take that decision either way and part from
the float64 step by far more than rounding.  The walk then holds a step to
``gate_band``: the float64 steps with every such decision taken either
way.  Here small nets are built with four gates exactly at zero (two
units, two rows) and, for K4, one row's ratio at the upper clip edge; the
band must hold the plain version's float64 step and the float64 steps
whose inputs were moved just across each edge, and must not hold the
float64 step with the learning rate 1% high (the walk's control).
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ppoc_tpu_torch.models import mlp
from ppoc_tpu_torch.ops import cuda_update as cu
from ppoc_tpu_torch.ops.adam import AdamState

MB, LR, CLIP, ENT = 32, 1e-3, 0.2, 0.01
EPS = 1e-13          # how far an input moves across a gate


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hyper(lr=LR):
    return cu.Hyper.of(lr, 0.9, 0.999, 1e-8)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(0, 1, shape))
                            .astype(np.float32))


def _adam0(tree):
    if isinstance(tree, torch.Tensor):
        return AdamState(torch.zeros_like(tree), torch.zeros_like(tree), 0)
    z = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in tree]
    return AdamState(z, [(w.clone(), b.clone()) for w, b in z], 0)


def _net(rng):
    """A random [4, 16, 16, 1] net."""
    return [(_t(rng, a, b, scale=1 / math.sqrt(a)), _t(rng, b, scale=0.1))
            for a, b in [(4, 16), (16, 16), (16, 1)]]


def _at_gates(params):
    """First hidden units 0 and 1 exactly at their gates for obs [1, 0,
    0, 0] (W0[0, u] + b0[u] = 0); feature 0 moves both across, feature 1
    unit 0 alone up and unit 1 alone down."""
    w0, b0 = params[0]
    w0[0, :2], b0[:2] = torch.tensor([0.5, 0.25]), torch.tensor([-0.5, -0.25])
    w0[1, :2] = torch.tensor([0.75, -0.75])


def _value_case(seed):
    """(state, rows, extra): K3 with Adam moments from three plain steps,
    rows 0 and 1 at the gates."""
    rng = np.random.default_rng(seed)
    params = _net(rng)
    params, opt, _ = cu.value_phase_plain(
        _t(rng, 3 * MB, 4), _t(rng, 3 * MB), params, _adam0(params), 3, MB,
        "relu", _hyper())
    _at_gates(params)
    obs = _t(rng, MB, 4)
    obs[:2] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    return (params, opt), [obs, _t(rng, MB)], ()


def _policy_rows(rng, params, log_std):
    """(obs, actions, old log-probs, advantages): ratios exp(N(0, 0.2)),
    but 1 at rows 0 and 1 (unclipped: their gates carry gradient); row 2's
    action at the float32 mean and its old log-prob set so its ratio sits
    at the upper clip edge, with a positive advantage."""
    obs = _t(rng, MB, 4)
    obs[:2] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    mu = mlp.apply(params, obs, "relu")
    act = mu + _t(rng, MB, 1) * torch.exp(log_std)
    act[2] = mu[2]
    lp = _log_prob(params, log_std, obs.double(), act.double())
    old = lp + torch.from_numpy(rng.normal(0, 0.2, MB))
    old[:2] = lp[:2]
    old[2] = lp[2] - math.log(1 + CLIP)
    adv = _t(rng, MB)
    adv[2] = 1.0
    return [obs, act, old.float(), adv]


def _log_prob(params, log_std, obs, act):
    """The float64 log-prob of ``act`` under the net at ``obs``."""
    mu = mlp.apply([(w.double(), b.double()) for w, b in params], obs, "relu")
    ls = log_std.double()
    z = (act - mu) * torch.exp(-ls)
    return (-0.5 * ls.shape[0] * math.log(2 * math.pi) - ls.sum()
            - 0.5 * (z * z).sum(dim=1))


def _policy_case(seed):
    """(state, rows, extra): K4 with moments from three plain steps, rows
    0 and 1 at the gates, row 2 at the clip edge; log_std at the constant
    of the log-prob so that row's log-prob is near zero (its ratio then
    rounds finely)."""
    rng = np.random.default_rng(seed)
    params = _net(rng)
    log_std = torch.full((1,), -0.5 * math.log(2 * math.pi))
    warm = _policy_rows(rng, params, log_std)
    warm = [torch.cat([c] * 3) for c in warm]
    params, log_std, opt, opt_ls, _, _ = cu.policy_phase_plain(
        *warm, params, log_std, _adam0(params), _adam0(log_std), 3, MB,
        "relu", _hyper(), CLIP, ENT)
    log_std = torch.full((1,), -0.5 * math.log(2 * math.pi))
    _at_gates(params)
    rows = _policy_rows(rng, params, log_std)
    return (params, log_std, opt, opt_ls), rows, (CLIP, ENT)


def _step64(state, rows, extra, lr=LR):
    """The plain version's float64 step, flattened as check_phase's
    weights (the net, then log_std)."""
    def d(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        if isinstance(x, AdamState):
            return AdamState(d(x.m), d(x.v), x.t)
        return [(w.double(), b.double()) for w, b in x]

    plain = cu.policy_phase_plain if extra else cu.value_phase_plain
    out = plain(*(r.double() for r in rows), *(d(x) for x in state), 1, MB,
                "relu", _hyper(lr), *extra)
    return torch.cat([mlp.flatten(out[0])]
                     + ([out[1].reshape(-1)] if extra else []))


CASES = {"K3": _value_case, "K4": _policy_case}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_gate_band_holds_every_setting_of_the_gates(kind, seed):
    cs = _chip_smoke()
    state, rows, extra = CASES[kind](seed)
    band, n_near = cs.gate_band(state, rows, _hyper(), extra)
    assert n_near == 4 + (kind == "K4")
    base = _step64(state, rows, extra)
    assert cs.outside(base, band) <= 1e-12
    moved = []
    for row in ([0], [1], [0, 1]):
        # feature 0 up: both units on; feature 1 up: unit 0; down: unit 1
        for feature, move in ((0, EPS), (1, EPS), (1, -EPS)):
            m = [r.double() for r in rows]
            m[0][row, feature] += move
            moved.append(m)
    if kind == "K4":
        # row 2's old log-prob to either side of the upper clip edge
        params, log_std = state[:2]
        lp = _log_prob(params, log_std, rows[0][2:3].double(),
                       rows[1][2:3].double())[0]
        sides = []
        for side in (1e-12, -1e-12):
            m = [r.double() for r in rows]
            m[2][2] = lp - math.log(1 + CLIP) + side
            moved.append(m)
            sides.append(_step64(state, m, extra))
        # below the edge the row carries its gradient, above it not
        assert float((sides[0] - sides[1]).abs().max()) > 1e-6
    for m in moved:
        step = _step64(state, m, extra)
        assert cs.outside(step, band) <= 1e-9
    for m in moved[:9]:
        assert float((_step64(state, m, extra) - base).abs().max()) > 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_gate_band_does_not_hold_a_learning_rate_fault(kind, seed):
    cs = _chip_smoke()
    state, rows, extra = CASES[kind](seed)
    band, _ = cs.gate_band(state, rows, _hyper(), extra)
    fault = _step64(state, rows, extra, lr=1.01 * LR)
    assert cs.outside(fault, band) > cs.STEP_TOL
