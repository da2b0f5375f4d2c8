"""K7's tile skip (``csrc/attn.cu`` ``list_visits``, in Python
``cuda_attn.visited_tiles``), and the bf16 variant's rounding controls.

A block of the forward or dq owns a tile of query rows and walks the key
tiles up to its causal bound; a block of dk/dv owns key rows and walks the
query tiles from its first key on.  It skips a tile whose episode-id range
does not meet its own rows'.  These tests hold that no valid (query, key)
pair ever falls in a skipped tile, on random layouts from a numpy seed
(p_done 0 to 0.5, rel -1/0/+1, ragged T, the key side from another window
or with ids in no order), at each block size the kernels take; that the
rule is the range test a plain loop gives; that it skips most tiles at
the X-ray layout and none over one episode.  Then the controls that the
card checks must tell apart from the bf16 kernels: l summed from bf16(p),
and sums rounded toward zero (``chip_smoke.py``'s lean check).  The
kernels themselves are held on the card (tests/test_torch_cuda.py).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.ops import cuda_attn as ca

# (rows a block, rows a tile): the f32 kernels, the bf16 kernels
BLOCKS = [(ca.ROWS, ca.TILE), (ca.BF16_ROWS, ca.TILE)]


def _ids(done: np.ndarray) -> torch.Tensor:
    """[T, B] done flags -> [B, T] int32 episode ids (the path's)."""
    return ca.fold_ep(attn.episode_ids(torch.tensor(done)))


def _layout(rng, T: int, B: int, rel: int, kind: str):
    """(ep_q, ep_k) of a random layout: the key side is the query side's
    window for rel 0 and +1; for rel -1 another window's ids ("window"),
    or ids in no order ("shuffled")."""
    p_done = float(rng.uniform(0.0, 0.5))
    ep_q = _ids(rng.random((T, B)) < p_done)
    if rel != -1:
        return ep_q, ep_q
    if kind == "window":
        ep_k = _ids(rng.random((T, B)) < p_done)
        return ep_q, ep_k + int(rng.integers(-3, 4))
    return ep_q, torch.tensor(rng.integers(0, 6, (B, T)), dtype=torch.int32)


def _covered(ep_q, ep_k, rel: int, rows: int, span: int, keys: bool):
    """[B, T, T] bool (query t, key s): the pairs the visited tiles hold."""
    visited, _ = ca.visited_tiles(ep_q, ep_k, rel, rows, span, keys)
    B, T = ep_q.shape
    cov = torch.zeros(B, T, T, dtype=torch.bool)
    for b, i, m in visited.nonzero().tolist():
        r0 = i * rows
        if keys:
            q0 = (0 if rel < 0 else r0) + m * span
            cov[b, q0:q0 + span, r0:r0 + rows] = True
        else:
            cov[b, r0:r0 + rows, m * span:(m + 1) * span] = True
    return cov


@pytest.mark.parametrize("draw", [0, 1])
@pytest.mark.parametrize("keys", [False, True], ids=["fwd-dq", "dkv"])
@pytest.mark.parametrize("rows,span", BLOCKS)
@pytest.mark.parametrize("rel,kind", [(0, "window"), (1, "window"),
                                      (-1, "window"), (-1, "shuffled")])
def test_no_valid_pair_falls_in_a_skipped_tile(rel, kind, rows, span, keys,
                                               draw):
    rng = np.random.default_rng(1000 + 10 * rel + rows + keys + 100 * draw)
    for T in (1, 15, 17, 63, 64, 65, 130, 257):
        ep_q, ep_k = _layout(rng, T, 3, rel, kind)
        valid = ca.valid_mask(ep_q, ep_k, rel, 1)
        cov = _covered(ep_q, ep_k, rel, rows, span, keys)
        assert not (valid & ~cov).any(), (T, rel, kind)


def _visited_loop(ep_q, ep_k, rel: int, rows: int, span: int, keys: bool):
    """The rule as csrc/attn.cu states it, one tile at a time."""
    own, other = (ep_k, ep_q) if keys else (ep_q, ep_k)
    B, T = own.shape
    out = np.zeros((B, -(-T // rows), -(-T // span)), dtype=bool)
    for b in range(B):
        for i in range(out.shape[1]):
            r0 = i * rows
            mine = own[b, r0:r0 + rows]
            if keys:
                starts = range(0 if rel < 0 else r0 if rel == 0 else T, T,
                               span)
            else:
                n_keys = T if rel < 0 else min(T, r0 + rows) if rel == 0 \
                    else 0
                starts = range(0, n_keys, span)
            for m, s0 in enumerate(starts):
                theirs = other[b, s0:s0 + span]
                out[b, i, m] = bool(theirs.min() <= mine.max()
                                    and theirs.max() >= mine.min())
    return out


@pytest.mark.parametrize("keys", [False, True], ids=["fwd-dq", "dkv"])
@pytest.mark.parametrize("rel", [-1, 0, 1])
def test_visited_tiles_is_the_range_test(rel, keys):
    rng = np.random.default_rng(7 + rel)
    for T, rows in ((97, 32), (200, 64), (64, 16)):
        ep_q, ep_k = _layout(rng, T, 2, rel, "shuffled")
        visited, in_range = ca.visited_tiles(ep_q, ep_k, rel, rows, ca.TILE,
                                             keys)
        want = _visited_loop(ep_q, ep_k, rel, rows, ca.TILE, keys)
        np.testing.assert_array_equal(visited.numpy(), want)
        assert not (visited & ~in_range).any()


@pytest.mark.parametrize("keys", [False, True], ids=["fwd-dq", "dkv"])
def test_the_xray_layout_skips_most_tiles(keys):
    """T 2048, B 16, p_done 0.02 (episodes of ~50 steps): an f32 block
    (ca.ROWS rows) meets two or three of the other side's tiles, so under
    a quarter of the in-range tiles are visited; over one episode every
    one is: block i's key tiles up to its last row (fwd, dq), or its query
    tiles from its first row on (dk/dv)."""
    rng = np.random.default_rng(3)
    ep = _ids(rng.random((2048, 16)) < 0.02)
    visited, in_range = ca.visited_tiles(ep, ep, 0, ca.ROWS, ca.TILE, keys)
    share = float(visited.sum()) / float(in_range.sum())
    assert share < 0.25, share
    one = _ids(np.zeros((2048, 2), dtype=bool))
    visited, in_range = ca.visited_tiles(one, one, 0, ca.ROWS, ca.TILE, keys)
    blocks = range(2048 // ca.ROWS)
    per_row = sum(-(-(2048 - i * ca.ROWS) // ca.TILE) if keys
                  else -(-(i + 1) * ca.ROWS // ca.TILE) for i in blocks)
    assert torch.equal(visited, in_range)
    assert int(in_range.sum()) == 2 * per_row == 2 * 1056


def test_rel_plus_one_visits_nothing():
    ep = _ids(np.zeros((130, 2), dtype=bool))
    for keys in (False, True):
        visited, in_range = ca.visited_tiles(ep, ep, 1, keys=keys)
        assert not in_range.any() and not visited.any()


def test_bf16_rounding_control_parts_from_the_plain_forward():
    """attention_plain_bf16(round_l=True) sums l from bf16(p): on most
    elements it parts from the plain version by more than the card check
    lets pass (1e-5 of the leaf's largest magnitude on at most 1% of
    them), so that check sees where l is summed; out only, lse is held at
    1e-5 besides."""
    rng = np.random.default_rng(11)
    T, B, H, hd = 256, 2, 2, 8
    q, k, v = (torch.tensor(rng.standard_normal((B * H, T, hd)),
                            dtype=torch.bfloat16) for _ in range(3))
    ep = _ids(rng.random((T, B)) < 0.02)
    want, _ = ca.attention_plain_bf16(q, k, v, ep, ep, 0, H)
    control, _ = ca.attention_plain_bf16(q, k, v, ep, ep, 0, H,
                                         round_l=True)
    top = max(1.0, float(want.abs().max()))
    apart = float(((control - want).abs() > 1e-5 * top).double().mean())
    assert apart > 0.5, apart


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_sum_toward_zero_rounds_every_step_toward_zero():
    """cuda_attn._sum_toward_zero against a loop over the steps: each
    step's exact sum added to the running float32 sum, then moved to the
    float32 neighbour nearer zero where rounding to nearest went past."""
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.standard_normal((2, 3, 40)), dtype=torch.bfloat16)
    b = torch.tensor(rng.standard_normal((2, 40, 5)), dtype=torch.bfloat16)
    acc = torch.tensor(rng.standard_normal((2, 3, 5)), dtype=torch.float32)
    got = ca._sum_toward_zero(a.float(), b.float(), acc)
    want = acc.numpy().copy()
    a64, b64 = a.double().numpy(), b.double().numpy()
    for k0 in range(0, 40, 16):
        x = want.astype(np.float64) + a64[..., k0:k0 + 16] @ b64[
            ..., k0:k0 + 16, :]
        y = x.astype(np.float32)
        want = np.where(np.abs(y.astype(np.float64)) > np.abs(x),
                        np.nextafter(y, np.float32(0)), y)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, (acc.double() + a.double() @ b.double())
                           .float())


def _float64_sums(q, k, v, ep_q, ep_k, rel, H, dout, dsum, lse):
    """The bf16 backward's plain version with each sum taken in float64 and
    rounded once: the same sums in another order, leaning neither way."""
    w, ds, qf, kf, dof = ca._bwd_terms_bf16(q, k, v, ep_q, ep_k, rel, H,
                                            dout, dsum, lse)

    def product(x, y):
        return (x.double() @ y.double()).to(torch.bfloat16)

    return (product(ds, kf), product(ds.transpose(1, 2), qf),
            product(ca._bf16(w).transpose(1, 2), dof))


@pytest.fixture(scope="module")
def leans():
    """chip_smoke.lean_bf16 at a recall_xl-like case (T 1024, B 4, H 4,
    hd 8, one episode a row, inputs from numpy seeds), the kernels standing
    in as the plain forward and :func:`_float64_sums`; and LEAN_TOL."""
    cs = _chip_smoke()
    T, B, H, hd = 1024, 4, 4, 8

    def make(seed):
        rng = np.random.default_rng(seed)
        q, k, v, dout = (torch.tensor(rng.standard_normal((B * H, T, hd)),
                                      dtype=torch.float32) for _ in range(4))
        g_lse = torch.tensor(rng.standard_normal((B * H, T)),
                             dtype=torch.float32)
        ep = _ids(np.zeros((T, B), dtype=bool))
        return q, k, v, dout, g_lse, ep, ep

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ca, "flash_fwd_kernel", ca.attention_plain_bf16)
        mp.setattr(ca, "flash_dq_kernel", lambda *a: _float64_sums(*a)[0])
        mp.setattr(ca, "flash_dkv_kernel", lambda *a: _float64_sums(*a)[1:])
        return cs.lean_bf16(make, 21, 0, H)[0], cs.LEAN_TOL


@pytest.mark.parametrize("i,output", enumerate(["out", "dq", "dk", "dv"]))
def test_lean_check_sees_sums_rounded_toward_zero(leans, i, output):
    """The card's lean check passes sums taken in another order and fails
    the control (toward_zero=True) on each output, over a recall_xl row's
    1024 keys."""
    lean, tol = leans
    assert abs(lean["kernel"][i]) <= tol, lean["kernel"]
    assert lean["control"][i] < -tol, lean["control"]
