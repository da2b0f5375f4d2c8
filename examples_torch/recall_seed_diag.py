"""Mechanistic diagnosis of the recall_long seed-1 init trap.

The port of ``examples/recall_seed_diag.py``.  recall_long (cue at t=0,
blank thereafter, reward at t=511 iff the action sign matches the cue)
solves on 7/8 seeds with the standard attention recipe in the JAX
package's record; seed 1 plateaus at R ~ 0.59 (docs/RESULTS.md round-4
record).  This script trains a seed with the exact recipe and instruments
the trunk every few epochs:

  * cue attention  -- softmax weight the FINAL query (t = T-1) places on
    key 0 (the cue position), per layer/head, probe batch of both cue
    signs (the retrieval circuit IS this weight -> 1 on some head);
  * attention entropy of the final query's distribution, per layer/head;
  * cue separation -- |mu(+cue) - mu(-cue)| at the final step: does ANY
    cue signal reach the action?;
  * value separation -- |V(+) - V(-)| at the final step: does the CRITIC
    see the cue (its gradient is what builds the advantage signal)?;
  * log_std -- exploration collapse;
  * cue-path weight norms: embed row 0 (cue channel) and pos row 0.

:func:`probe` is a hand-unrolled ``models/attn.apply_seq`` in PyTorch that
also returns the final-query attention maps, held to the JAX script's
``probe`` by ``tests/test_torch_examples.py``.  The rows go to
``recall_diag_torch_s<seed>.jsonl`` (the JAX script writes
``recall_diag_s<seed>.jsonl``, which the repo keeps), in the working
directory.  The card's walls: PERF.md §6.

Runs on CUDA device 0; ``PPOC_PLATFORM=cpu`` pins the CPU.

Usage: python examples_torch/recall_seed_diag.py [seed] [epochs] [probe_every] [aux]
"""
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer, platform_device
from ppoc_tpu_torch.models import attn as attn_mod, mlp

T = 512


def recipe(seed, aux=0.0):
    return PPOConfig(env="recall_long", rollout_len=T, eval_len=T,
                     n_envs=32, minibatch_size=4096, fits_per_epoch=2,
                     eval_envs=64, hidden=(32,), seed=seed,
                     lr_policy=1e-3, lr_v=1e-3, aux_value_coeff=aux,
                     attn_dim=32, attn_layers=2, attn_heads=4)


def probe_obs(device):
    """[T, 2, obs_dim]: the two cue sequences (+1 and -1)."""
    obs = torch.zeros((T, 2, 2), device=device)
    obs[0, 0] = torch.tensor((1.0, 1.0))     # cue +1, first-step flag
    obs[0, 1] = torch.tensor((-1.0, 1.0))
    return obs


@torch.no_grad()
def probe(policy_params, v_params):
    """-> dict of instrumentation from a hand-unrolled apply_seq that also
    returns the final-query attention maps (models/attn.py internals)."""
    device = v_params["attn"]["pos"].device
    xs = probe_obs(device)                            # [T, 2, 2]
    reset_after = torch.zeros((T, 2), dtype=torch.bool, device=device)
    out = {}
    for name, params in (("pol", policy_params["mlp"]), ("val", v_params)):
        attn = params["attn"]
        pos = attn["pos"][:T].reshape(T, 1, -1)
        h = attn_mod._embed(attn, xs) + pos
        mask = attn_mod.causal_episode_mask(reset_after)
        cue_w, ent = [], []
        for blk in attn["blocks"]:
            u = attn_mod._ln(h, blk["ln1"])
            q, k, v = attn_mod._qkv(blk, u)
            hd = q.shape[-1]
            scores = torch.einsum("tbhk,sbhk->tsbh", q, k) / math.sqrt(hd)
            scores = torch.where(mask[..., None], scores, attn_mod.NEG_INF)
            w = torch.softmax(scores, dim=1)          # [Tq, Tk, 2, H]
            last = w[T - 1]                           # [Tk, 2, H]
            cue_w.append(last[0])                     # weight on key 0 [2, H]
            ent.append(-torch.sum(last * torch.log(last + 1e-12), dim=0))
            o = torch.einsum("tsbh,sbhk->tbhk", w, v)
            h = h + attn_mod._dot(o.reshape(o.shape[:-2] + (-1,)),
                                  blk["wo"], False) + blk["bo"]
            h = h + attn_mod._ff(attn_mod._ln(h, blk["ln2"]), blk, "relu")
        head_in = attn_mod._ln(h, attn["lnf"])
        head = mlp.apply(params["head"], head_in, "relu", "jnp")
        out[f"{name}_cue_w"] = torch.stack(cue_w)     # [L, 2, H]
        out[f"{name}_attn_ent"] = torch.stack(ent)    # [L, 2, H]
        out[f"{name}_final"] = head[T - 1]            # [2, out]
        out[f"{name}_embed_cue_norm"] = torch.linalg.norm(
            attn["embed"][0][0])                      # cue channel row
        out[f"{name}_pos0_norm"] = torch.linalg.norm(attn["pos"][0])
    return out


def row_from_probe(p):
    p = {k: v.cpu().numpy() for k, v in p.items()}
    return {
        # best head's cue weight (max over layers/heads, mean over signs)
        "pol_cue_w_max": float(np.max(np.mean(p["pol_cue_w"], axis=1))),
        "val_cue_w_max": float(np.max(np.mean(p["val_cue_w"], axis=1))),
        "pol_attn_ent_min": float(np.min(np.mean(p["pol_attn_ent"], axis=1))),
        "val_attn_ent_min": float(np.min(np.mean(p["val_attn_ent"], axis=1))),
        "mu_sep": float(np.abs(p["pol_final"][0] - p["pol_final"][1]).max()),
        "v_sep": float(np.abs(p["val_final"][0] - p["val_final"][1]).max()),
        "embed_cue_norm": float(p["pol_embed_cue_norm"]),
        "pos0_norm": float(p["pol_pos0_norm"]),
    }


def main(argv) -> int:
    seed = int(argv[1]) if len(argv) > 1 else 1
    n_epochs = int(argv[2]) if len(argv) > 2 else 40
    every = int(argv[3]) if len(argv) > 3 else 2
    aux = float(argv[4]) if len(argv) > 4 else 0.0

    tr = Trainer(recipe(seed, aux), platform_device())
    path = f"recall_diag_torch_s{seed}.jsonl" if aux == 0.0 \
        else f"recall_diag_torch_s{seed}_aux{aux:g}.jsonl"
    rows = []
    with open(path, "w") as f:
        for ep in range(n_epochs):
            t0 = time.time()
            tr.train_epoch()
            if ep % every == 0 or ep == n_epochs - 1:
                ev = tr.evaluate()
                row = {"epoch": ep, "R": float(ev.R),
                       "log_std": float(
                           tr.state.policy_params["log_std"].mean()),
                       **row_from_probe(probe(tr.state.policy_params,
                                              tr.state.v_params)),
                       "s": round(time.time() - t0, 1)}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
                print(json.dumps(row), flush=True)
    print(f"# wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
