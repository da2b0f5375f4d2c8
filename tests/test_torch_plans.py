"""The launch plans that K2 and K7's float32 kernels take, as pure
functions (the kernels' own rules in Python; tests/test_torch_cuda.py holds
K2's to the built kernel's on the card), and the lean verdicts of
``chip_smoke.py``'s rounding checks.

K2 (``cuda_gae.plan``): one block where a buffer's deltas and done flags
fit its shared memory, else a cluster of at most 16 blocks of a multiple
of 32 env columns, with the steps in chunks where a block's columns do not
fit.  K7 f32 (``cuda_attn.f32_plan``, ``cuda_attn.deal``): 32 own rows a
block, the visited tiles dealt to the warp groups in turn.  Milliseconds:
no tensor work.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ppoc_tpu_torch.ops import cuda_attn as ca, cuda_gae

# the card's dynamic shared memory a block may take (H100), and the
# static arrays of K7's f32 kernels beside it (the visit list and flags)
OPTIN, F32_STATIC = 232448, 4 * 256 + 256 + 4


@pytest.mark.parametrize("T,E,want", [
    (200, 64, (1, 64, 200)),        # the bench: one block, as before
    (200, 1024, (16, 64, 200)),     # the throughput shape
    (150, 4096, (16, 256, 150)),    # the reacher regime
    (999, 512, (16, 32, 999)),      # MountainCarContinuous
    (200, 229, (1, 229, 200)),      # the last width one block holds
    (200, 230, (8, 32, 200)),       # the first it does not
    (200, 1000, (16, 64, 200)),     # E no multiple of the columns
    (1, 64, (1, 64, 1)),
    (5000, 64, (2, 32, 1432)),      # past a cluster's shared memory
])
def test_gae_plan_at_the_paths_and_edges(T, E, want):
    p = cuda_gae.plan(T, E)
    assert (p.blocks, p.cols, p.rows) == want
    assert p.smem <= cuda_gae.SMEM


def test_gae_plan_covers_every_column_within_shared_memory():
    rng = np.random.default_rng(0)
    for _ in range(400):
        T = int(rng.integers(1, 3000))
        E = int(rng.integers(1, 20000))
        p = cuda_gae.plan(T, E)
        assert 1 <= p.blocks <= cuda_gae.MAX_BLOCKS
        assert p.blocks * p.cols >= E > (p.blocks - 1) * p.cols
        assert (p.blocks == 1) == (5 * T * E <= cuda_gae.SMEM)
        if p.blocks > 1:
            assert p.cols % 32 == 0
        assert 1 <= p.rows <= T
        assert (p.rows == T) == (5 * T * p.cols <= cuda_gae.SMEM)
        assert p.smem <= cuda_gae.SMEM


def test_gae_plan_refuses_what_the_kernel_cannot_take():
    """At most 16 blocks by construction, so the only refusals are an
    empty buffer and a block whose columns cannot hold two steps: 500,000
    envs are 16 blocks of 31,264 columns, one step a chunk at T = 1 and
    none past it."""
    assert cuda_gae.plan(1, 500000)[:3] == (16, 31264, 1)
    with pytest.raises(ValueError, match="cannot hold one step"):
        cuda_gae.plan(2, 500000)
    for T, E in ((0, 64), (64, 0)):
        with pytest.raises(ValueError, match="T, E >= 1"):
            cuda_gae.plan(T, E)


def test_gae_kernel_on_the_cpu_is_its_plain_version():
    g = torch.Generator().manual_seed(1)
    T, E = 30, 5
    r, v, nv = (torch.randn(T, E, generator=g) for _ in range(3))
    term = torch.rand(T, E, generator=g) < 0.1
    trunc = (torch.rand(T, E, generator=g) < 0.1) & ~term
    args = (r, v, nv, term, trunc, 0.99, 0.95)
    for a, b in zip(cuda_gae.gae_norm_fused(*args),
                    cuda_gae.gae_norm_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd", ca.SUPPORTED_HD)
def test_f32_plan_fits_the_card(hd):
    p = ca.f32_plan(hd)
    assert p.rows == ca.ROWS == 32 and p.tile == ca.TILE
    assert p.rows % 16 == 0 and p.threads == 32 * (p.rows // 16) * p.splits
    assert p.threads <= 1024 and p.stages in (1, 2)
    assert p.smem + F32_STATIC <= OPTIN
    # the forward's merge area (every group past the first: m, l, o a
    # lane) and dk/dv's (dk and dv a lane) fit in the groups' buffers
    warps_past = (p.splits - 1) * (p.rows // 16)
    buffers = p.splits * p.stages * (2 * ca.TILE * (hd + 4) + 3 * ca.TILE)
    assert warps_past * 32 * 2 * hd <= buffers
    with pytest.raises(ValueError, match="head dims"):
        ca.f32_plan(12)


def test_deal_gives_each_visited_tile_to_one_group_in_turn():
    rng = np.random.default_rng(2)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        visited = sorted(rng.choice(64, size=min(n, 64),
                                    replace=False).tolist())
        for splits in (2, 4):
            groups = ca.deal(visited, splits)
            assert len(groups) == splits
            assert sorted(sum(groups, [])) == visited
            assert all(g == sorted(g) for g in groups)
            sizes = [len(g) for g in groups]
            assert sizes == sorted(sizes, reverse=True)
            assert max(sizes) == -(-len(visited) // splits)
    assert ca.deal([3], 4) == [[3], [], [], []]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_lean_verdicts_fail_a_leaning_kernel_and_pass_the_control_check():
    """A kernel within float32 rounding of float64 passes, one leaning
    toward zero by ~8 ulps fails its lean, and a control with ~13 bits
    dropped fails its RMS part, as chip_smoke holds K5 and K7 f32."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    want = torch.randn(4096, generator=g, dtype=torch.float64)

    def noisy(bits, lean=0.0):
        e = torch.randn(4096, generator=g, dtype=torch.float64)
        return (want * (1 + 2.0 ** -bits * e - lean)).float()

    ref = {"x": want}
    got = {"kernel": {"x": noisy(24)}, "plain": {"x": noisy(24)},
           "control": {"x": noisy(11)}}
    rows, failed, control = cs.lean_verdicts(ref, got, cs.FLASH_RMS_FACTOR,
                                             cs.FLASH_LEAN_FACTOR)
    assert failed == [] and control == ["x"]
    got["kernel"] = {"x": noisy(24, lean=8 * 2.0 ** -24)}
    _, failed, _ = cs.lean_verdicts(ref, got, cs.FLASH_RMS_FACTOR,
                                    cs.FLASH_LEAN_FACTOR)
    assert failed == ["x"]


def test_flash_tf32_bounds_scale_with_the_products():
    cs = _chip_smoke()
    fwd, dq, dkv = cs.flash_tf32_bounds(10 ** 6, 8)
    assert fwd == pytest.approx(1e3 * 3 * 4 * 8 * 1e6 / cs.PEAK_TF32)
    assert (dq / fwd, dkv / fwd) == (pytest.approx(1.5), pytest.approx(2.0))


@pytest.mark.parametrize("case", ["clean", "stray launch", "busy stream"])
def test_phase_clock_times_the_host_between_calls(case, monkeypatch):
    """chip_smoke.PhaseClock on stand-ins for the card's stream: the host's
    time between the wrapped calls is timed as "host"; a counted launch
    between them, or a long wait for a busy stream, fails the split."""
    import time

    from ppoc_tpu_torch.algo import ppo
    from ppoc_tpu_torch.ops import _build

    cs = _chip_smoke()
    counter = _build.LaunchCount("k")
    busy = [case == "busy stream"]

    class Stream:
        def query(self):
            return not busy[0]

    def synchronize():
        if busy[0]:
            busy[0] = False
            time.sleep(0.3)     # device work queued outside the phases

    def phase():
        counter.n += 1
        time.sleep(0.1)

    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    monkeypatch.setattr(ppo, "draw_fit", lambda: time.sleep(0.1))
    monkeypatch.setattr(ppo, "rollout", phase)
    clock = cs.PhaseClock([counter], (("ppo", "draw_fit", "draws"),
                                      ("ppo", "rollout", "rollout")))
    t0 = time.perf_counter()
    with clock:
        ppo.draw_fit()
        time.sleep(0.05)        # the host's own code between the phases
        if case == "stray launch":
            counter.n += 1
        ppo.rollout()
    wall = time.perf_counter() - t0
    assert ppo.rollout is phase
    if case != "clean":
        with pytest.raises(AssertionError):
            clock.split(wall)
        return
    split = clock.split(wall)
    assert clock.launches == {"draws": {"k": 0}, "rollout": {"k": 1}}
    assert split["host"] >= 0.05 and split["draws"] >= 0.1
    assert sum(split.values()) == pytest.approx(wall)
