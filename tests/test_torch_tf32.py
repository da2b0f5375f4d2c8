"""K5's float32-accurate tensor-core products, on the CPU: the tf32 split.

The card runs K5's products as 3xTF32 ``mma.sync`` steps (csrc/mma.cuh
``mma_3xtf32``): each float32 operand x is split into big = rna(x) and
small = rna(x - big), two tf32 values, and a product sums a_small b_big +
a_big b_small + a_big b_big.  ``cuda_mlp.tf32_dot`` emulates the split with
the sums in float64, where a product of two tf32 values is exact, so what
is left is what the split drops.  The 3-term product must stay within
float32 rounding of float64: an RMS error of at most two unit roundoffs of
the result, and every element within the classical bound of a float32
dot product of K terms, gamma_K = K u / (1 - K u) times sum |a| |b|.  One
tf32 term (what ``allow_tf32`` does) keeps ~11 bits and must fail both.
Also the launch's pure rules: the row tile and the backward's cluster.
"""
import numpy as np
import pytest
import torch

from ppoc_tpu_torch.ops import cuda_mlp

U = 2.0 ** -24   # float32's unit roundoff


def _case(K: int, seed: int):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.standard_normal((24, K)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((K, 16)) / np.sqrt(K),
                     dtype=torch.float32)
    exact = a.double() @ b.double()
    bound = K * U / (1 - K * U) * (a.double().abs() @ b.double().abs())
    return a, b, exact, bound


def _rms(err, exact) -> float:
    return float(err.square().mean().sqrt() / exact.square().mean().sqrt())


def test_tf32_round_is_cvt_rna():
    """To a 10-bit mantissa, to nearest, ties away from zero; the low 13
    bits are clear and the rounding error is at most half a tf32 ulp."""
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -23, 1 + 3 * 2 ** -12, 0.0, -2.5])
    assert cuda_mlp.tf32_round(x).tolist() == [
        1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10, 0.0, -2.5]
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 1e3
    t = cuda_mlp.tf32_round(r)
    assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((t - r).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("K,seed", [(8, 0), (64, 1), (256, 2)])
def test_three_term_product_stays_within_float32_rounding(K, seed):
    a, b, exact, bound = _case(K, seed)
    err = cuda_mlp.tf32_dot(a, b, terms=3) - exact
    assert _rms(err, exact) <= 2 * U
    assert bool((err.abs() <= bound).all())


@pytest.mark.parametrize("K,seed", [(8, 0), (64, 1), (256, 2)])
def test_one_term_product_does_not(K, seed):
    a, b, exact, bound = _case(K, seed)
    err = cuda_mlp.tf32_dot(a, b, terms=1) - exact
    assert _rms(err, exact) > 100 * U
    assert bool((err.abs() > bound).any())


def test_tile_for_takes_the_smallest_tile_of_one_wave():
    """The smallest tile whose grid fits the resident blocks in one wave;
    past every tile, the largest that fits a block (its blocks loop)."""
    resident = {16: 264, 32: 132, 48: 132, 64: 132, 80: 132}
    assert cuda_mlp.tile_for(1, resident) == 16
    assert cuda_mlp.tile_for(16 * 264, resident) == 16
    assert cuda_mlp.tile_for(16 * 264 + 1, resident) == 48
    assert cuda_mlp.tile_for(8192, resident) == 64
    assert cuda_mlp.tile_for(8192, {t: 112 for t in resident}) == 80
    assert cuda_mlp.tile_for(16384, {16: 132, 32: 132, 48: 132,
                                     64: 132}) == 64
    assert cuda_mlp.tile_for(300, {64: 1}) == 64


def test_cluster_for_covers_the_tiles_up_to_sixteen():
    assert [cuda_mlp.cluster_for(n) for n in (1, 2, 3, 5, 9, 16, 17, 512)] \
        == [1, 2, 4, 8, 16, 16, 16, 16]
