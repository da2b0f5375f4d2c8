"""The port's examples (``examples_torch/``) on the CPU.

Each script keeps its JAX counterpart's configs, arguments and printed
lines (``examples/`` under the same file name), so at full size it runs
for minutes here.  These tests shrink the work from outside: they patch a
script's module-level configs (or its ``recipe``) to a few envs and
narrow nets, pass its own arguments (epochs, windows), and run its
``main`` in a temporary working directory with ``PPOC_PLATFORM=cpu``.
Also: no script imports jax or the JAX package; the torch ``probe`` of
``recall_seed_diag`` against the JAX script's on the same params; the
curriculum's resume by evaluation, where the JAX script assumes R 0.95;
and the committed lunar-lander artifact replayed through the port's CLI
to the JAX CLI's R.
"""
import filecmp
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppoc_tpu_torch import PPOConfig
from ppoc_tpu_torch.algo.trainer import Trainer
from ppoc_tpu_torch.models import attn
from ppoc_tpu_torch.utils import params as conv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("attn_long_context", "calibrated_mountain_car", "gym_bipedal",
         "gym_bipedal_refine", "hparam_grid", "moe_expert_parallel",
         "recall_bf16_bisect", "recall_seed_diag", "recall_xl_curriculum",
         "recurrent_memory", "train_pendulum")
# the small sizes every shrunken run shares
SMALL = dict(n_envs=4, rollout_len=16, minibatch_size=32, fits_per_epoch=1,
             n_epochs_value=1, n_epochs_policy=1, eval_envs=4,
             hidden=(8, 8))
RECALL = dict(env="recall", n_envs=8, rollout_len=6, eval_len=6,
              minibatch_size=48, fits_per_epoch=1, n_epochs_value=1,
              n_epochs_policy=1, eval_envs=8, hidden=(8,))


def load(name, package="examples_torch"):
    """Import a script as a module of its own (a fresh copy each call)."""
    path = os.path.join(REPO, package, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"_{package}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("PPOC_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)


def test_every_single_device_example_is_ported():
    """The JAX package's examples minus data_tensor_parallel (all mesh,
    ROADMAP.md §1 item 16)."""
    jax_names = {f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                 if f.endswith(".py")}
    ported = {f[:-3] for f in os.listdir(os.path.join(REPO,
                                                      "examples_torch"))
              if f.endswith(".py")}
    assert ported == set(NAMES) == jax_names - {"data_tensor_parallel"}


def test_examples_never_import_jax():
    """Importing every script loads no jax module and none of the JAX
    package's."""
    code = ("import importlib.util, sys\n"
            f"for n in {NAMES!r}:\n"
            "    s = importlib.util.spec_from_file_location(\n"
            "        n, f'examples_torch/{n}.py')\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ppoc_tpu' or "
            "m.startswith('ppoc_tpu.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)


def test_the_card_by_default(monkeypatch):
    """Unset, PPOC_PLATFORM means CUDA device 0: without CUDA a script
    refuses rather than fall back to the CPU."""
    monkeypatch.delenv("PPOC_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="PPOC_PLATFORM=cpu"):
        load("train_pendulum").main(["train_pendulum.py"])


def test_train_pendulum(capsys):
    mod = load("train_pendulum")
    mod.CFG = PPOConfig(env="pendulum", **SMALL)
    mod.MAX_EPOCHS = 1
    assert mod.main(["train_pendulum.py"]) == 0
    assert re.search(r"solved=False after 1 epochs, R=-\d+\.\d",
                     capsys.readouterr().out)
    tr = Trainer.from_checkpoint("ppo_model.bin", "cpu")
    assert tr.cfg == mod.CFG and tr.state.opt_v.t > 0


def test_attn_long_context(capsys):
    mod = load("attn_long_context")
    mod.BASE = PPOConfig(**RECALL)
    assert mod.main(["attn_long_context.py", "1"]) == 0
    out = capsys.readouterr().out
    for name in ("attn", "gru", "mlp"):
        assert re.search(rf"^{name:5s}: final R \d\.\d\d  best", out, re.M)


def test_recurrent_memory(capsys):
    mod = load("recurrent_memory")
    mod.RECALL = PPOConfig(**RECALL, n_epochs=1)
    mod.PO = PPOConfig(env="pendulum_po", rnn_hidden=4, n_epochs=1,
                       **dict(SMALL, hidden=(8,), eval_envs=2))
    assert mod.main(["recurrent_memory.py"]) == 0
    out = capsys.readouterr().out
    assert out.count("Epoch: 0 ") == 3 and "== GRU on pendulum_po" in out


def test_calibrated_mountain_car(capsys):
    mod = load("calibrated_mountain_car")
    mod.BASE = PPOConfig(env="mountain_car", ent_coeff=0.005, eval_len=16,
                         **SMALL)
    mod.CALIBRATE = dict(n_envs=8, n_steps=16)
    with pytest.warns(UserWarning, match="eval_len"):
        assert mod.main(["calibrated_mountain_car.py", "1"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"calibrated in [\d.]+s: loc=\(.*\) scale=\(.*\)", out)
    assert "final R" in out and "at epoch 0" in out


def test_hparam_grid(capsys):
    mod = load("hparam_grid")
    mod.CFG = mod.CFG.replace(**SMALL)
    mod.AXES = {"lr_policy": [1e-4, 1e-3], "clip_eps": [0.2]}
    mod.SEEDS = [0]
    assert mod.main(["hparam_grid.py", "1"]) == 0
    out = capsys.readouterr().out
    assert "grid 1: 2 lanes, one after another" in out
    assert "grid 2 (zoomed): 9 lanes" in out and out.count("<- best") == 2


def test_moe_expert_parallel(capsys):
    mod = load("moe_expert_parallel")
    mod.CFG = PPOConfig(env="pendulum", n_experts=4, n_epochs=1, **SMALL)
    assert mod.main(["moe_expert_parallel.py"]) == 0
    assert capsys.readouterr().out.count("Epoch: ") == 3


def test_recall_bf16_bisect(capsys):
    """Nine legs; BF16_SITES is set by each leg and restored after."""
    mod = load("recall_bf16_bisect")
    seen = []
    real = mod.Trainer

    def spy(cfg, device):
        seen.append((cfg.kernel_backend, attn.BF16_SITES))
        return real(cfg, device)

    mod.Trainer = spy
    mod.recipe = lambda seed, backend: PPOConfig(
        **RECALL, seed=seed, kernel_backend=backend, attn_dim=8,
        attn_layers=1, attn_heads=2)
    assert mod.main(["recall_bf16_bisect.py", "1", "0"]) == 0
    assert len(seen) == 9 and seen[0] == ("jnp", frozenset(mod.ALL))
    assert {len(s) for b, s in seen[2:]} == {6} and all(
        b == "bf16" for b, _ in seen[1:])
    assert attn.BF16_SITES == frozenset(mod.ALL)
    assert capsys.readouterr().out.count("best R") == 9


def test_recall_seed_diag(capsys):
    mod = load("recall_seed_diag")
    mod.T = 12
    mod.recipe = lambda seed, aux=0.0: PPOConfig(
        **dict(RECALL, rollout_len=12, eval_len=12), seed=seed,
        aux_value_coeff=aux, attn_dim=8, attn_layers=1, attn_heads=2)
    assert mod.main(["recall_seed_diag.py", "1", "2", "1"]) == 0
    rows = open("recall_diag_torch_s1.jsonl").read().splitlines()
    assert len(rows) == 2 and "pol_cue_w_max" in rows[0]
    assert "# wrote recall_diag_torch_s1.jsonl" in capsys.readouterr().out


def test_seed_diag_probe_matches_jax(monkeypatch):
    """The torch probe against the JAX script's jitted probe on the same
    params (the port's init carried across by the numpy conversion), at
    T 16 with an episode table of 33 slots: every output within rtol 1e-4
    / atol 1e-5 (the tolerance of the port's attention parity tests)."""
    jmod = load("recall_seed_diag", "examples")
    mod = load("recall_seed_diag")
    monkeypatch.setattr(jmod, "T", 16)
    mod.T = 16
    cfg = PPOConfig(env="recall_long", rollout_len=32, eval_len=32,
                    n_envs=4, minibatch_size=128, hidden=(32,),
                    attn_dim=32, attn_layers=2, attn_heads=4, seed=5)
    ts = Trainer(cfg, "cpu").state
    # a trained-looking cue path: the policy's pos row 0 and embed row
    # moved off their init so the maps are not uniform
    g = torch.Generator().manual_seed(1)
    for p in (ts.policy_params["mlp"], ts.v_params):
        p["attn"]["pos"] += 0.5 * torch.randn(p["attn"]["pos"].shape,
                                              generator=g)
    got = mod.probe(ts.policy_params, ts.v_params)
    jts = conv.train_state_to_numpy(ts)
    want = jmod.probe(jax.tree.map(jnp.asarray, jts.policy_params),
                      jax.tree.map(jnp.asarray, jts.v_params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert mod.row_from_probe(got) == pytest.approx(
        jmod.row_from_probe(want), rel=1e-4, abs=1e-5)


def _recall_file(path, seed, epochs):
    """A tiny recall attention checkpoint (window 6), trained ``epochs``."""
    tr = Trainer(PPOConfig(**dict(RECALL, n_envs=32, fits_per_epoch=4,
                                  n_epochs_value=2, n_epochs_policy=2,
                                  hidden=(16,), eval_envs=64),
                           seed=seed, attn_dim=16, attn_layers=1,
                           attn_heads=2, lr_policy=3e-3, lr_v=3e-3), "cpu")
    h = tr.train(n_epochs=epochs, log=False, stop_at_R=0.95) if epochs else []
    tr.save(path)
    return h


def _curriculum(package):
    mod = load("recall_xl_curriculum", package)
    mod.STAGES = {6: "recall"}
    if package == "examples":
        mod.enable_compilation_cache = lambda: None
    else:
        mod.MB_MIN = 48
    return mod


def test_curriculum_resume_evaluates_the_stage(tmp_path, capsys):
    """The reference's fault, pinned: a resumed stage whose file holds an
    untrained policy.  The JAX script takes R 0.95 without evaluating
    (examples/recall_xl_curriculum.py:82) and exits 0; the port's
    evaluates it, prints the R and exits 1.  Neither rewrites a file."""
    _recall_file("recall_curriculum_512_s0.bin", 0, 0)
    shutil.copy("recall_curriculum_512_s0.bin", "recall_curriculum_6_s0.bin")
    shutil.copy("recall_curriculum_6_s0.bin", tmp_path / "orig.bin")
    argv = ["recall_xl_curriculum.py", "0", "6"]
    assert _curriculum("examples").main(argv) == 0
    assert _curriculum("examples_torch").main(argv) == 1
    out = capsys.readouterr().out
    r = float(re.search(r"T=6 \(recall\): resumed from "
                        r"recall_curriculum_6_s0.bin, evaluated R "
                        r"([\d.]+)", out).group(1))
    assert r < 0.9
    assert filecmp.cmp("recall_curriculum_6_s0.bin", tmp_path / "orig.bin",
                       shallow=False)
    assert sorted(os.listdir(".")) == [
        "orig.bin", "recall_curriculum_512_s0.bin",
        "recall_curriculum_6_s0.bin"]


def test_curriculum_resume_of_a_trained_stage_exits_0(capsys):
    """A stage file whose policy solves (trained here: the tiny recipe,
    seed 1, stops at R >= 0.95) resumes, evaluates >= 0.9 and exits 0,
    writing nothing."""
    h = _recall_file("recall_curriculum_6_s0.bin", 1, 12)
    assert h[-1]["R"] >= 0.95
    shutil.copy("recall_curriculum_6_s0.bin", "recall_curriculum_512_s0.bin")
    assert _curriculum("examples_torch").main(
        ["recall_xl_curriculum.py", "0", "6"]) == 0
    assert "phase 1 (T=512): resuming" in capsys.readouterr().out
    assert len(os.listdir(".")) == 2


def test_gym_bipedal_then_refine(capsys):
    """The pair on Gymnasium's Pendulum-v1 (ENV_ID; the refine script's
    env_id argument), shrunk: train and save, then refine from the file."""
    pytest.importorskip("gymnasium")
    tiny = dict(SMALL, eval_envs=1, eval_len=200, reset_per_fit=False,
                kernel_backend="jnp")
    mod = load("gym_bipedal")
    mod.ENV_ID = "Pendulum-v1"
    mod.config = lambda n_epochs, seed: PPOConfig(
        **tiny, n_epochs=n_epochs, seed=seed)
    assert mod.main(["gym_bipedal.py", "1", "0", "1", "g.bin", "1"]) == 0
    assert os.path.exists("g.bin.obsnorm.npz")
    ref = load("gym_bipedal_refine")
    ref.config = lambda n_epochs, seed, lr, eval_len: PPOConfig(
        **dict(tiny, eval_len=eval_len), n_epochs=n_epochs, seed=seed,
        lr_policy=lr, lr_v=lr)
    assert ref.main(["gym_bipedal_refine.py", "g.bin", "r.bin", "1", "7",
                     "1", "3e-4", "300", "Pendulum-v1", "200"]) == 0
    out = capsys.readouterr().out
    assert "[det] epoch 1: R" in out and os.path.exists("r.bin")
    assert '"best_det_R"' in out


def test_lunar_lander_artifact_replays_to_the_jax_figure():
    """``python -m ppoc_tpu_torch`` with artifacts/README.md's replay flags
    for lunar_lander.bin plus --eval-only --det-eval: R 236.406586, the JAX
    CLI's figure on the same command, within 1e-4."""
    pytest.importorskip("gymnasium")
    cmd = [sys.executable, "-m", "ppoc_tpu_torch",
           "--env", "gym:LunarLanderContinuous-v3", "--actor", "host",
           "--obs-norm", "--reward-norm", "--n-envs", "16",
           "--rollout-len", "256", "--minibatch-size", "256",
           "--fits-per-epoch", "4", "--eval-envs", "8", "--eval-len", "1000",
           "--reset-per-fit", "false",
           "--load", os.path.join(REPO, "artifacts", "lunar_lander.bin"),
           "--eval-only", "--det-eval"]
    out = subprocess.run(cmd, check=True, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  PPOC_PLATFORM="cpu"), timeout=300).stdout
    r = float(re.search(r"R: (-?[\d.]+)", out).group(1))
    assert r == pytest.approx(236.406586, abs=1e-4)
