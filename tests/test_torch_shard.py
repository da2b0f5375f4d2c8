"""K3 and K4 for nets past one block's shared memory run as one
thread-block cluster that shards the weights by column
(csrc/update_shard.cuh).  Without a card this holds what the launch takes
from Python: the sharded block's layout and shared memory
(cuda_update.shard_layout, the same as the C side's size function, which
tests/test_torch_cuda.py holds on the card), and that ppo.kernel_fit at
the H100's 232,448 B admits every net whose K3, K4 or K6 it admitted when
the slot was a one-block kernel staging 32 weight rows at a time, K6 now
sized by the same two cluster maps as K3 and K4.
"""
import pytest

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo import ppo
from ppoc_tpu_torch.ops import cuda_update

H100_OPTIN = 232448


def _staged_bytes(widths):
    """The bytes the slot took before: one block staging 32 rows of the
    widest layer + 1, and the 1 KB static share."""
    return 4 * 32 * (max(widths) + 1) + 1024


def test_shard_bytes_follow_the_layout():
    """[10,256,256,1] on 16 blocks: layer 0 replicated (W0 12 x 260 + b0
    256), layer 1 by column (W1 256 x 20: 16 columns padded to 4 * odd,
    + b1 16), the head by row (W2 16 x 4 + b2 4): 8,580 floats, twice
    with the gradient; 64-row tiles of 260 + 20 + 4 columns (+ 8); two
    exchange tiles of 64 x 4 and a zero bias of 4; two sub-tiles of x (64
    x 12) and of the extras (64 x 12); the row stats (64 x 12), log_std's
    state (32), the head bias's m and v (2 x 4); m and v of the block's
    own elements: its slice of layer 0 (53 of its 844 float4s), layer 1's
    257 x 16 (the shard's weights and bias) and the head's 16 x 1."""
    lay = cuda_update.shard_layout((10, 256, 256, 1))
    assert lay.kinds == ["REP", "COL", "ROW"] and lay.sub == 64
    assert lay.moments and not lay.spill
    floats = (2 * (12 * 260 + 256 + 256 * 20 + 16 + 16 * 4 + 4)
              + 64 * (260 + 20 + 4) + 8 + 2 * 64 * 4 + 4 + 2 * 64 * 12
              + 2 * 64 * 12 + 64 * 12 + 32 + 2 * 4
              + 2 * (4 * 53 + 257 * 16 + 16 * 1))
    assert lay.nbytes == cuda_update.shard_bytes((10, 256, 256, 1)) == (
        4 * floats) == 193680
    # two action dims: the head's own m and v hold 16 x 2
    assert cuda_update.shard_bytes((10, 256, 256, 2)) == lay.nbytes + 4 * 32


@pytest.mark.parametrize("depth,kinds", [
    (1, ["ROW"]), (2, ["COL", "ROW"]), (3, ["REP", "COL", "ROW"]),
    (4, ["COL", "ROW", "COL", "ROW"]),
    (5, ["REP", "COL", "ROW", "COL", "ROW"]),
    (8, ["COL", "ROW"] * 4)])
def test_shard_kinds_alternate_from_the_head(depth, kinds):
    """The head takes its rows, the layer below its columns, and so on
    down; layer 0 where it would take rows is replicated instead (the
    inputs are 3-10 wide), unless it is the head."""
    widths = (10,) + (64,) * (depth - 1) + (2,)
    assert cuda_update.shard_layout(widths).kinds == kinds


@pytest.mark.parametrize("hidden,sub,moments,spill", [
    ((141, 141), 64, True, False), ((256, 256), 64, True, False),
    ((448, 448), 32, False, False), ((452, 452), 16, False, False),
    ((256, 256, 256), 32, False, False), ((448, 448, 448), 32, False, True),
    ((452,) * 7, 16, False, True)])
def test_shard_sub_tile_shrinks_then_spills(hidden, sub, moments, spill):
    """The sub-tile is the largest of 64, 32, 16 whose block fits 227 KB,
    with the block's own Adam moments where they fit too; past that every
    COL and ROW weight and its gradient spill to a global scratch and the
    sub-tile is the largest that fits again."""
    lay = cuda_update.shard_layout((10, *hidden, 2))
    assert (lay.sub, lay.moments, lay.spill) == (sub, moments, spill)
    assert lay.nbytes + 1024 <= H100_OPTIN


def test_shard_bytes_shrink_with_the_cluster():
    """More blocks, smaller shards: the block's bytes fall from 4 to 8 to
    16 blocks, and 4 blocks take a smaller sub-tile at 2x256."""
    w = (10, 256, 256, 1)
    lays = [cuda_update.shard_layout(w, c) for c in (4, 8, 16)]
    assert lays[0].nbytes > lays[1].nbytes > lays[2].nbytes
    assert lays[0].sub == 32 and lays[2].sub == 64


@pytest.mark.parametrize("env", ["reacher", "pendulum"])
def test_kernel_fit_admits_every_width_it_did(env):
    """Reacher and pendulum at hidden (h, h) for h 140-452: K3 and K4
    take a variant wherever the one-block slot took one (all of them), the
    replicated cluster up to its boundary (h 140 for pendulum's value
    net), the sharded one past it, and their bytes are the two clusters'
    blocks."""
    for h in range(140, 453):
        cfg = PPOConfig(env=env, hidden=(h, h))
        fits = {k.kernel[:2]: k for k in ppo.kernel_fit(cfg, H100_OPTIN)}
        for name in ("K3", "K4"):
            k = fits[name]
            widths = k.widths[0]
            assert _staged_bytes(widths) <= H100_OPTIN
            assert k.nbytes == (cuda_update.cluster_bytes(widths) + 1024,
                                cuda_update.shard_bytes(widths) + 1024)
            assert k.variant == ("smem" if k.nbytes[0] <= H100_OPTIN
                                 else "global"), (h, name)
    pend = ppo.kernel_fit(PPOConfig(env="pendulum", hidden=(141, 141)),
                          H100_OPTIN)[3]
    assert pend.kernel.startswith("K3") and pend.variant == "global"


@pytest.mark.parametrize("hidden", [(448, 448, 448), (452, 452, 452, 452),
                                    (256,) * 7])
def test_kernel_fit_admits_deep_nets(hidden):
    """A 3-, a 4- and a 7-hidden-layer net: K3 and K4 take the sharded
    cluster (its weights spilled where the shards pass shared memory)."""
    for env in ("reacher", "pendulum"):
        fits = {k.kernel[:2]: k for k in ppo.kernel_fit(
            PPOConfig(env=env, hidden=hidden), H100_OPTIN)}
        assert fits["K3"].variant == fits["K4"].variant == "global"


@pytest.mark.parametrize("env,K", [("cartpole", 2), ("acrobot", 3)])
def test_k6_verdicts_are_unchanged(env, K):
    """K6 is a kind of K3's and K4's two cluster kernels: its bytes are the
    replicated cluster's block, then the sharded cluster's (the same maps
    as K3's and K4's: a row's extras hold the class id, its stats the
    entropy), and its variant follows them at every width."""
    obs = {"cartpole": 4, "acrobot": 6}[env]
    for h in range(100, 453, 7):
        fits = {k.kernel[:2]: k for k in ppo.kernel_fit(
            PPOConfig(env=env, hidden=(h, h)), H100_OPTIN)}
        w = (obs, h, h, K)
        want = (cuda_update.cluster_bytes(w) + 1024,
                cuda_update.shard_bytes(w) + 1024)
        assert fits["K6"].widths == (w,)
        assert fits["K6"].nbytes == want
        assert fits["K6"].variant == ("smem" if want[0] <= H100_OPTIN
                                      else "global")


def _one_block_bytes(widths):
    """K6's bytes when its slot was one block: its padded weights (each W_l
    row d_{l+1} + 1 floats, plus the biases), then one staged slice of 32
    rows of the widest layer + 1; each with the 1 KB static share."""
    padded = 4 * sum(a * (b + 1) + b for a, b in zip(widths[:-1],
                                                    widths[1:]))
    return padded + 1024, _staged_bytes(widths)


@pytest.mark.parametrize("env", ["cartpole", "acrobot"])
def test_kernel_fit_admits_every_k6_width_it_did(env):
    """Cartpole and acrobot at hidden (h, h) for h 100-452: K6 takes a
    variant wherever its one-block slot took one (all of them), the
    replicated cluster up to its boundary and the sharded one past it."""
    smem = []
    for h in range(100, 453):
        k6 = {k.kernel[:2]: k for k in ppo.kernel_fit(
            PPOConfig(env=env, hidden=(h, h)), H100_OPTIN)}["K6"]
        before = _one_block_bytes(k6.widths[0])
        assert min(before) <= H100_OPTIN, h
        assert k6.variant is not None, h
        smem.append(k6.variant == "smem")
    # the replicated cluster to a boundary, the sharded cluster past it
    n = smem.index(False)
    assert 100 + n - 1 >= 128 and not any(smem[n:])


@pytest.mark.parametrize("env", ["cartpole", "acrobot"])
def test_kernel_fit_admits_deep_k6_nets(env):
    """Three hidden layers of 448: K6 takes the sharded cluster with its
    COL and ROW weights spilled to global memory, as K3 does."""
    cfg = PPOConfig(env=env, hidden=(448, 448, 448))
    fits = {k.kernel[:2]: k for k in ppo.kernel_fit(cfg, H100_OPTIN)}
    assert fits["K6"].variant == fits["K3"].variant == "global"
    assert cuda_update.shard_layout(fits["K6"].widths[0]).spill
