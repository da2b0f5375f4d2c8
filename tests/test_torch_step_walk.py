"""chip_smoke.py's step walk at the ReLU gates and clip branches, on the CPU.

Where a row's pre-activation lies within float32 rounding of a ReLU gate,
or (K4, K6) its probability ratio within rounding of a clip edge, any float32
step of the update phase may take that decision either way and part from
the float64 step by far more than rounding.  The walk then holds a step to
``gate_band``: the float64 steps with every such decision taken either
way.  Here small nets are built with four gates exactly at zero (two
units, two rows) and, for K4 and K6 (a 3-class categorical head), one
row's ratio at the upper clip edge; the
band must hold the plain version's float64 step and the float64 steps
whose inputs were moved just across each edge, and must not hold the
float64 step with the learning rate 1% high (the walk's control).  For
the sharded cluster alone the band also lets each gradient element
near Adam's eps range over its float32 rounding bound (``near_eps``,
``rounding``), which must hold the float32 gradient summed in any order,
stay tight on nearly every element, and widen the band at a few elements
alone.
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


def _dbl(rows):
    """The rows in float64, the class ids as they are."""
    return [r.double() if r.is_floating_point() else r.clone() for r in rows]


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


def _cat_log_prob(params, obs, cls):
    """The float64 log-prob of the classes ``cls`` under the net at
    ``obs``."""
    y = mlp.apply([(w.double(), b.double()) for w, b in params], obs, "relu")
    return torch.log_softmax(y, dim=1).gather(1, cls.long())[:, 0]


def _categorical_rows(rng, params):
    """(obs, class ids, old log-probs, advantages) of a 3-class policy:
    ratios exp(N(0, 0.2)), but 1 at rows 0 and 1 (unclipped: their gates
    carry gradient, with advantage 2 so that moving a gate moves the step
    visibly); row 2's old log-prob set so its ratio sits at the upper clip
    edge, with a positive advantage."""
    obs = _t(rng, MB, 4)
    obs[:2] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    cls = torch.from_numpy(rng.integers(0, 3, (MB, 1)).astype(np.int32))
    lp = _cat_log_prob(params, obs.double(), cls)
    old = lp + torch.from_numpy(rng.normal(0, 0.2, MB))
    old[:2] = lp[:2]
    old[2] = lp[2] - math.log(1 + CLIP)
    adv = _t(rng, MB)
    adv[:2], adv[2] = 2.0, 1.0
    return [obs, cls, old.float(), adv]


def _categorical_case(seed):
    """(state, rows, extra): K6 on a [4, 16, 16, 3] net with moments from
    three plain steps, rows 0 and 1 at the gates, row 2 at the clip
    edge."""
    rng = np.random.default_rng(seed)
    params = _net(rng)
    params[-1] = (_t(rng, 16, 3, scale=0.25), _t(rng, 3, scale=0.1))
    warm = [torch.cat([c] * 3) for c in _categorical_rows(rng, params)]
    params, opt, _, _ = cu.policy_phase_categorical_plain(
        *warm, params, _adam0(params), 3, MB, "relu", _hyper(), CLIP, ENT)
    _at_gates(params)
    return (params, opt), _categorical_rows(rng, params), (CLIP, ENT)


def _step64(state, rows, extra, lr=LR):
    """The plain version's float64 step, flattened as check_phase's
    weights (the net, then log_std)."""
    def d(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        if isinstance(x, AdamState):
            return AdamState(d(x.m), d(x.v), x.t)
        return [(w.double(), b.double()) for w, b in x]

    plain = (cu.value_phase_plain if not extra
             else cu.policy_phase_plain if len(state) == 4
             else cu.policy_phase_categorical_plain)
    out = plain(*_dbl(rows), *(d(x) for x in state), 1, MB, "relu",
                _hyper(lr), *extra)
    return torch.cat([mlp.flatten(out[0])]
                     + ([out[1].reshape(-1)] if len(state) == 4 else []))


CASES = {"K3": _value_case, "K4": _policy_case, "K6": _categorical_case}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_gate_band_holds_every_setting_of_the_gates(kind, seed):
    cs = _chip_smoke()
    state, rows, extra = CASES[kind](seed)
    band, n_near = cs.gate_band(state, rows, _hyper(), extra)
    assert n_near == 4 + (kind != "K3")
    base = _step64(state, rows, extra)
    assert cs.outside(base, band) <= 1e-12
    moved = []
    for row in ([0], [1], [0, 1]):
        # feature 0 up: both units on; feature 1 up: unit 0; down: unit 1
        for feature, move in ((0, EPS), (1, EPS), (1, -EPS)):
            m = _dbl(rows)
            m[0][row, feature] += move
            moved.append(m)
    if kind != "K3":
        # row 2's old log-prob to either side of the upper clip edge
        if kind == "K4":
            params, log_std = state[:2]
            lp = _log_prob(params, log_std, rows[0][2:3].double(),
                           rows[1][2:3].double())[0]
        else:
            lp = _cat_log_prob(state[0], rows[0][2:3].double(),
                               rows[1][2:3])[0]
        sides = []
        for side in (1e-12, -1e-12):
            m = _dbl(rows)
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


@pytest.mark.parametrize("kind", ["K3", "K4", "K6"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rounding_bounds_any_summation_order(kind, seed):
    """``chip_smoke.rounding``, gate_band's float32 rounding bound of each
    gradient element: the float32 gradient of the plain version's backward
    on the rows in eight orders (each order sums every element in another
    order) lies within the bound of the float64 gradient in every element,
    while the bound stays far below nearly every nonzero element (under 1%
    of |g| on 19 in 20 of them, from the worst case of 128-term sums), so
    only an element that cancels is left loose."""
    cs = _chip_smoke()
    from ppoc_tpu_torch.ops.cuda_mlp import backward_layers, forward_layers

    rng = np.random.default_rng(100 + seed)
    params = _net(rng)
    W = [w.double() for w, _ in params]
    B = [b.double() for _, b in params]
    obs = _t(rng, 4 * MB, 4)
    mb = obs.shape[0]
    k = {"K3": 1, "K4": 2, "K6": 3}[kind]
    if kind == "K4":
        params[-1] = (_t(rng, 16, 2, scale=0.25), _t(rng, 2, scale=0.1))
        W[-1], B[-1] = params[-1][0].double(), params[-1][1].double()
        ls = torch.tensor([-0.3, 0.2])
        act, lp, adv = _t(rng, mb, 2), _t(rng, mb, scale=0.3), _t(rng, mb)
        cols = [obs, act, lp, adv]
    elif kind == "K6":
        params[-1] = (_t(rng, 16, 3, scale=0.25), _t(rng, 3, scale=0.1))
        W[-1], B[-1] = params[-1][0].double(), params[-1][1].double()
        cls = torch.from_numpy(rng.integers(0, 3, (mb, 1)).astype(np.int32))
        lp = _t(rng, mb, scale=0.3) - math.log(3)
        cols = [obs, cls, lp, _t(rng, mb)]
    else:
        cols = [obs, _t(rng, mb, scale=3.0)]
    x = obs.double()
    z64, h = [], x
    for w, b in zip(W[:-1], B[:-1]):
        z64.append(h @ w + b)
        h = torch.relu(z64[-1])
    y64 = h @ W[-1] + B[-1]
    masks = [z > 0 for z in z64]

    def cotangent(y, dt):
        c = [t.to(dt) for t in cols]
        if kind == "K3":
            return (2.0 / mb) * (y[:, 0] - c[1])[:, None], None
        if kind == "K6":
            lpa = torch.log_softmax(y, dim=1)
            p = torch.exp(lpa)
            H = -(p * lpa).sum(dim=1, keepdim=True)
            onehot = torch.nn.functional.one_hot(c[1][:, 0].long(), k).to(dt)
            r = torch.exp(lpa.gather(1, c[1].long())[:, 0] - c[2])
            keep = (r * c[3] <= torch.clamp(r, 1 - CLIP, 1 + CLIP) * c[3])
            dlogp = -(c[3] * r / mb) * keep.to(dt)
            return (dlogp[:, None] * (onehot - p)
                    + (ENT / mb) * p * (lpa + H)), None
        s = torch.exp(-ls.to(dt))
        z = (c[1] - y) * s
        logp = (-0.5 * k * math.log(2 * math.pi) - ls.to(dt).sum()
                - 0.5 * (z * z).sum(dim=1))
        r = torch.exp(logp - c[2])
        keep = (r * c[3] <= torch.clamp(r, 1 - CLIP, 1 + CLIP) * c[3])
        dlogp = -(c[3] * r / mb) * keep.to(dt)
        return dlogp[:, None] * z * s, (dlogp[:, None] * (z * z - 1.0)
                                        ).sum(dim=0)

    def gradient(order, dt):
        xs = [t[order] for t in cols]
        ws = [w.to(dt) for w in W]
        hs = forward_layers(xs[0].to(dt), ws, [b.to(dt) for b in B], "relu")
        saved, cols[:] = list(cols), xs
        try:
            g, tail = cotangent(hs[-1], dt)
        finally:
            cols[:] = saved
        grads, _ = backward_layers(xs[0].to(dt), hs, g, ws, "relu")
        out = [t.reshape(-1) for t in grads] + ([tail] if tail is not None
                                                else [])
        return torch.cat(out).double()

    policy = None
    if kind == "K6":
        r64 = torch.exp(torch.log_softmax(y64, dim=1).gather(
            1, cls.long())[:, 0] - lp.double())
        unclipped = (r64 * cols[3].double()
                     <= torch.clamp(r64, 1 - CLIP, 1 + CLIP)
                     * cols[3].double())
    elif kind == "K4":
        lp0 = -0.5 * k * math.log(2 * math.pi)

        def ratio(mu, log_std, a, lpo):
            z = (a - mu) * torch.exp(-log_std)
            return torch.exp(lp0 - log_std.sum() - 0.5 * (z * z).sum(dim=1)
                             - lpo), z

        policy = (ls.double(), lp0, ratio)
        r64 = ratio(y64, ls.double(), cols[1].double(), cols[2].double())[0]
        unclipped = (r64 * cols[3].double()
                     <= torch.clamp(r64, 1 - CLIP, 1 + CLIP)
                     * cols[3].double())
    else:
        unclipped = None
    bound = cs.rounding(W, B, x, [c.double() for c in cols], z64, y64,
                        masks, unclipped, mb, policy,
                        ENT if kind == "K6" else None)
    g64 = gradient(torch.arange(mb), torch.float64)
    for i in range(8):
        order = torch.from_numpy(np.random.default_rng(i).permutation(mb))
        g32 = gradient(order, torch.float32)
        assert bool(((g32 - g64).abs() <= bound).all()), i
    nz = g64 != 0
    assert float((bound[nz] < 1e-2 * g64[nz].abs()).double().mean()) > 0.95


def _relabel(tree, perms):
    """A net (or a moment tree like it) with hidden layer l's units in the
    order ``perms[l]``: the same function, summed in another order."""
    out, prev = [], None
    for l, (w, b) in enumerate(tree):
        if prev is not None:
            w = w[prev]
        if l < len(tree) - 1:
            w, b, prev = w[:, perms[l]], b[perms[l]], perms[l]
        out.append((w.contiguous(), b.contiguous()))
    return out


def test_rounding_near_eps_is_confined_and_holds_any_order():
    """gate_band(near_eps=True), the band chip_smoke holds the sharded
    K3/K4 cluster to: on the rows where a card test of that kernel needed
    it (K3 on [3,160,160,160,1], seed 0, the first minibatch of 64, Adam
    at t 5 from zero moments) the gradient's rounding widens the band at
    a few elements alone, each within ROUND_NEAR eps, and nowhere else
    (one of them past 4 eps, so "a few eps" would not reach it); there
    the plain version's float32 step in eight summation orders
    (rows and hidden units relabelled) lies inside the band in every
    order, while some order lies more than STEP_TOL outside the band
    without the rounding: float32 arithmetic itself parts from the
    replicated kernels' yardstick at those elements."""
    from ppoc_tpu_torch import PPOConfig, envs
    from ppoc_tpu_torch.algo import ppo

    cs = _chip_smoke()
    cfg = PPOConfig(env="pendulum", hidden=(160, 160, 160))
    ts = ppo.init_train_state(cfg, envs.make("pendulum"),
                              torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(0)
    cols = [torch.randn(20 * 64, d, generator=g) * s
            for d, s in ((3, 1.0), (1, 1.0), (1, 0.3), (1, 1.0))]
    x, tgt = cols[0][:64], cols[3][:64, 0] * 50
    hyper = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    params, opt = ts.v_params, ts.opt_v._replace(t=5)
    band0, _ = cs.gate_band((params, opt), [x, tgt], hyper)
    band, _ = cs.gate_band((params, opt), [x, tgt], hyper, near_eps=True)
    wider = (band[1] - band[0]) > (band0[1] - band0[0])
    assert 1 <= int(wider.sum()) <= 8
    assert torch.equal(band[0][~wider], band0[0][~wider])
    assert torch.equal(band[1][~wider], band0[1][~wider])
    def f64(tree):
        return [(w.double(), b.double()) for w, b in tree]

    exact = cu.value_phase_plain(
        x.double(), tgt.double(), f64(params),
        AdamState(f64(opt.m), f64(opt.v), opt.t), 1, 64, "relu", hyper)
    v_hat = mlp.flatten(exact[1].v) / cu._bias_corrections(opt.t + 1,
                                                           hyper)[1]
    knee = v_hat[wider].sqrt() / hyper.eps
    assert bool((knee <= cs.ROUND_NEAR).all()) and float(knee.max()) > 4
    worst = 0.0
    for seed in range(8):
        rng = torch.Generator().manual_seed(seed)
        rows = torch.randperm(64, generator=rng)
        perms = [torch.randperm(160, generator=rng) for _ in range(3)]
        inv = [torch.argsort(p) for p in perms]
        out = cu.value_phase_plain(
            x[rows], tgt[rows], _relabel(params, perms),
            AdamState(_relabel(opt.m, perms), _relabel(opt.v, perms), opt.t),
            1, 64, "relu", hyper)
        w = mlp.flatten(_relabel(out[0], inv)).double()[wider]
        assert bool(((band[0][wider] <= w) & (w <= band[1][wider])).all())
        worst = max(worst, float(torch.maximum(band0[0][wider] - w,
                                               w - band0[1][wider]).max()))
    assert worst > cs.STEP_TOL


@pytest.mark.parametrize("near_eps", [False, True])
def test_gate_band_steps_log_std_at_its_own_timestep(near_eps):
    """K4 with two action dims, the net's Adam at t 3 and log_std's at t 7:
    the band holds the plain version's float64 step in every element, each
    log_std element stepped with its own Adam's bias corrections (a band
    that split log_std by element stepped its first element with the net's
    timestep, 2.6e-5 away at 2x256)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(7)
    params = _net(rng)
    params[-1] = (_t(rng, 16, 2, scale=0.25), _t(rng, 2, scale=0.1))
    log_std = torch.tensor([-0.3, 0.2])
    rows = [_t(rng, MB, 4), _t(rng, MB, 2), _t(rng, MB, scale=0.3) - 2.0,
            _t(rng, MB)]
    state = (params, log_std, _adam0(params)._replace(t=3),
             _adam0(log_std)._replace(t=7))
    band, _ = cs.gate_band(state, rows, _hyper(), (CLIP, ENT), near_eps)
    step = _step64(state, rows, (CLIP, ENT))
    assert cs.outside(step, band) <= 1e-12
    assert float((band[1] - band[0])[-2:].abs().max()) <= 1e-12
