"""Numerically stable mean/variance (counterpart of ``ppoc_tpu/ops/welford.py``).

The pairwise-merge state (count n, mean, M2) is associative under
:func:`combine`, so :func:`from_array` reduces a tensor with a log-depth
halving tree.  Single device only: the cross-device merge of the triples
arrives with the data-parallel slice.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class WelfordState(NamedTuple):
    n: torch.Tensor     # f32 count
    mean: torch.Tensor  # f32
    m2: torch.Tensor    # f32 sum of squared deviations


def combine(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan/Welford pairwise merge."""
    n = a.n + b.n
    delta = b.mean - a.mean
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    mean = a.mean + delta * b.n / safe_n
    m2 = a.m2 + b.m2 + delta * delta * a.n * b.n / safe_n
    return WelfordState(n=n, mean=mean, m2=m2)


def from_array(x: torch.Tensor) -> WelfordState:
    """Reduce a tensor to one Welford state: halve it ceil(log2 N) times,
    merging element i with element i + half each round."""
    x = x.reshape(-1).to(torch.float32)
    st = WelfordState(n=torch.ones_like(x), mean=x, m2=torch.zeros_like(x))
    size = x.shape[0]
    while size > 1:
        half = (size + 1) // 2
        lo = WelfordState(*(s[:half] for s in st))
        hi = WelfordState(*(s[half:size] for s in st))
        if hi.n.shape[0] < half:   # odd: pad with an empty (n=0) state
            hi = WelfordState(*(torch.cat([s, s.new_zeros(1)]) for s in hi))
        st = combine(lo, hi)
        size = half
    return WelfordState(*(s[0] for s in st))


def mean_var(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Population mean and variance of ``x``."""
    st = from_array(x)
    return st.mean, st.m2 / torch.clamp(st.n, min=1.0)
