"""The port's CLI (ppoc_tpu_torch/cli.py, ``python -m ppoc_tpu_torch``) and
elastic supervisor (utils/supervisor.py), mirroring tests/test_cli.py and
tests/test_supervisor.py: every PPOConfig field a flag, the presets,
--save then --resume on the CPU (PPOC_PLATFORM=cpu), each flag whose
module is not ported refused by name, the supervisor's restart loop with
stub runners, and one fault drill end to end in subprocesses.  The host
bridge's gym:* path with its actor and normaliser flags, --sweep/--grid
and --profile route as the JAX CLI routes them, under its guards.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from ppoc_tpu import cli as jcli
from ppoc_tpu_torch import PPOConfig, cli, tuned_preset
from ppoc_tpu_torch.utils import checkpoint, supervisor
from test_torch_checkpoint import assert_leaves_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--env", "simple", "--n-envs", "8", "--rollout-len", "15",
        "--minibatch-size", "32", "--fits-per-epoch", "1", "--hidden", "8",
        "8", "--eval-envs", "8", "--eval-len", "15", "--seed", "1",
        "--n-epochs", "3"]


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("PPOC_PLATFORM", "cpu")
    monkeypatch.delenv("PPOC_FAULT_EPOCH", raising=False)


# --- parsing (tests/test_cli.py) -------------------------------------------------

def test_defaults_are_reference_preset():
    cfg = cli.config_from_args(cli.build_parser().parse_args([]))
    assert cfg.n_envs == 15 and cfg.rollout_len == 200
    assert cfg.minibatch_size == 64 and cfg.lr_policy == 3e-4


def test_presets_and_overrides_match_the_jax_cli():
    argv = ["--preset", "tpu", "--n-envs", "512", "--lr-policy", "1e-3",
            "--hidden", "256", "256", "--env", "cartpole", "--tp-size", "2",
            "--reset-per-fit", "false", "--obs-loc", "0.5,1"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert (cfg.n_envs, cfg.minibatch_size, cfg.lr_policy) == (512, 8192,
                                                               1e-3)
    assert cfg.hidden == (256, 256) and cfg.tp_size == 2
    assert cfg.reset_per_fit is False and cfg.obs_loc == (0.5, 1.0)
    for preset in ("reference", "tpu", "tuned"):
        a = ["--preset", preset] + argv[2:]
        ours = cli.config_from_args(cli.build_parser().parse_args(a))
        theirs = jcli.config_from_args(jcli.build_parser().parse_args(a))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "tuned"])) == tuned_preset()


def test_every_config_field_has_a_flag():
    opts = {a.dest for a in cli.build_parser()._actions}
    for f in dataclasses.fields(PPOConfig):
        assert f.name in opts, f"config field {f.name} missing from CLI"


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "4"], "item 16"), (["--coordinator", "h:1"], "item 16"),
    (["--num-processes", "2"], "item 16"), (["--process-id", "0"],
                                           "item 16"),
    (["--zero1", "true"], "item 16"),
    (["--n-experts", "2", "--ep-size", "2"], "item 16"),
])
def test_unported_flags_are_refused_by_name(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert item in err and "ppoc_tpu_torch: error:" in err


@pytest.mark.parametrize("argv", [
    ["--kernel-backend", "jnp"], ["--max-grad-norm", "0.5"], ["--calibrate"],
    ["--n-experts", "2", "--moe-topk", "1"],
    ["--rnn-hidden", "4", "--rnn-cell", "lstm"],
    ["--transplant-patience", "1", "--rnn-hidden", "4"],
    ["--aux-value-coeff", "0.5", "--attn-dim", "8", "--attn-layers", "1"],
])
def test_lifted_flags_train(argv, tmp_path, capsys, on_cpu):
    """The flags the port used to refuse (the "jnp" backend, the
    stabilisers, --calibrate, a mixture, a GRU/LSTM trunk, the transplant,
    the aux value head) now train and save; --calibrate writes its
    statistics into the config and says so."""
    ck = str(tmp_path / "l.bin")
    assert cli.main(BASE + argv + ["--n-epochs", "1", "--save", ck]) == 0
    cfg = checkpoint.load(ck).cfg
    if argv == ["--calibrate"]:
        assert len(cfg.obs_loc) == 1 and len(cfg.obs_scale) == 1
        assert "calibrated obs_loc=" in capsys.readouterr().err
    else:
        assert getattr(cfg, argv[0][2:].replace("-", "_")) != getattr(
            PPOConfig(), argv[0][2:].replace("-", "_"))


def test_calibrate_refusals(tmp_path, capsys):
    """--calibrate with --resume/--load, or with explicit statistics, is
    a parser error, as in the JAX CLI."""
    for argv in (["--calibrate", "--load", "x.bin"],
                 ["--calibrate", "--obs-loc", "0.0", "--obs-scale", "1.0"]):
        with pytest.raises(SystemExit) as e:
            cli.main(BASE + argv)
        assert e.value.code == 2
        assert "--calibrate" in capsys.readouterr().err


def test_flag_validation(capsys):
    for argv in (["--checkpoint-every", "1"],
                 ["--env", "simple", "--score-episodes", "10"],
                 ["--supervise", "2"],
                 ["--supervise", "2", "--save", "x.bin",
                  "--checkpoint-every", "1", "--solve-R", "0.5"]):
        with pytest.raises(SystemExit):
            cli.main(argv)


def test_cli_refuses_without_cuda_unless_pinned(monkeypatch, capsys):
    monkeypatch.delenv("PPOC_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # the card runs the CLI
    with pytest.raises(SystemExit):
        cli.main(BASE + ["--eval-only"])
    assert "PPOC_PLATFORM=cpu" in capsys.readouterr().err
    monkeypatch.setenv("PPOC_PLATFORM", "tpu")
    with pytest.raises(SystemExit):
        cli.main(BASE + ["--eval-only"])


# --- training runs on the CPU ------------------------------------------------------

def test_save_resume_eval_only(tmp_path, capsys, on_cpu):
    ck = str(tmp_path / "q.bin")
    assert cli.main(BASE + ["--save", ck, "--jsonl"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    assert {"R", "entropy", "value_loss"} <= set(rows[0])
    assert checkpoint.load(ck).meta == {"epochs_done": 3}
    # the whole schedule is done: --resume has nothing left ...
    assert cli.main(["--resume", ck]) == 0
    assert "nothing to resume" in capsys.readouterr().err
    # ... unless --n-epochs asks for more
    assert cli.main(["--resume", ck, "--n-epochs", "1", "--save", ck]) == 0
    assert "Epoch: 0" in capsys.readouterr().out
    assert checkpoint.load(ck).meta["epochs_done"] == 4
    assert cli.main(BASE + ["--eval-only", "--load", ck, "--det-eval"]) == 0
    assert "R:" in capsys.readouterr().out
    assert cli.main(BASE + ["--eval-only", "--load", ck,
                            "--score-episodes", "20"]) == 0
    assert "eval rounds" in capsys.readouterr().out


def test_resume_mid_schedule_equals_the_straight_run(tmp_path, on_cpu):
    """A 3-epoch run checkpointing each epoch, resumed from its epoch-1
    file with --resume, ends on the straight run's state bit for bit."""
    straight, mid = str(tmp_path / "s.bin"), str(tmp_path / "m.bin")
    assert cli.main(BASE + ["--save", straight, "--checkpoint-every",
                            "1"]) == 0
    assert cli.main(BASE[:-2] + ["--n-epochs", "1", "--save", mid]) == 0
    # the 1-epoch run's file carries n_epochs 1: finish 2 more explicitly
    assert cli.main(["--resume", mid, "--n-epochs", "2", "--save", mid,
                     "--checkpoint-every", "1"]) == 0
    a, b = checkpoint.load(straight), checkpoint.load(mid)
    assert b.meta["epochs_done"] == 3
    assert_leaves_equal(a.state, b.state)
    assert torch.equal(a.generator, b.generator)


def test_resume_of_a_jax_jnp_file_takes_the_backend_flag(tmp_path, capsys,
                                                         on_cpu):
    """A file the JAX package saved with kernel_backend "jnp" resumes on
    "jnp" as it is, and on the port's kernels with --kernel-backend."""
    from test_torch_checkpoint import write_jax_file

    p = str(tmp_path / "j.bin")
    write_jax_file(p, "dense_gaussian", "plain")
    with pytest.warns(checkpoint.DrawStreamWarning):
        assert cli.main(["--resume", p, "--n-epochs", "1"]) == 0
    with pytest.warns(checkpoint.DrawStreamWarning):
        assert cli.main(["--resume", p, "--n-epochs", "1", "--kernel-backend",
                         "pallas", "--save", p]) == 0
    ck = checkpoint.load(p)
    assert ck.cfg.kernel_backend == "pallas"
    assert ck.meta["epochs_done"] == 5


def test_solve_r(tmp_path, capsys, on_cpu):
    ck = str(tmp_path / "s.bin")
    assert cli.main(BASE + ["--solve-R=-1e9", "--save", ck]) == 0
    assert "solved=True epochs=1" in capsys.readouterr().out
    assert checkpoint.load(ck).cfg.env == "simple"


# --- supervisor (tests/test_supervisor.py) ------------------------------------------

def test_build_restart_argv():
    argv = ["--env", "simple", "--load", "old.bin", "--supervise", "3",
            "--save", "ck.bin", "--checkpoint-every", "1", "--n-epochs", "4",
            "--import-ref=r.bin", "--calibrate"]
    out = supervisor.build_restart_argv(argv, "ck.bin")
    assert out == ["--env", "simple", "--save", "ck.bin",
                   "--checkpoint-every", "1", "--resume", "ck.bin"]


def test_build_restart_argv_gym_uses_load():
    """A gym host-bridge run restarts from its flags with --load, keeping
    --n-epochs, as the JAX supervisor's."""
    from ppoc_tpu.utils import supervisor as jsupervisor

    argv = ["--env", "gym:Pendulum-v1", "--supervise", "3", "--save",
            "ck.bin", "--checkpoint-every", "1", "--n-epochs", "4",
            "--obs-norm", "--resume=x.bin"]
    out = supervisor.build_restart_argv(argv, "ck.bin", gym_env=True)
    assert out == jsupervisor.build_restart_argv(argv, "ck.bin", gym_env=True)
    assert out[-2:] == ["--load", "ck.bin"] and "--n-epochs" in out


GYM = ["--env", "gym:Pendulum-v1", "--n-envs", "4", "--rollout-len", "32",
       "--minibatch-size", "32", "--fits-per-epoch", "1", "--hidden", "8",
       "8", "--eval-envs", "2", "--eval-len", "200", "--n-epochs", "1"]


@pytest.mark.parametrize("argv", [
    [], ["--actor", "device"], ["--overlap"],
    ["--obs-norm", "--reward-norm", "--vector-mode", "sync"],
])
def test_gym_env_trains_through_the_host_bridge(argv, tmp_path, capsys,
                                                 on_cpu):
    """--env gym:<id> trains a GymTrainer (the JAX CLI's default actor
    "host"), skips the pre-training evaluation, saves the config under
    the gym name and, with --obs-norm/--reward-norm, both sidecars; --load
    restores them."""
    pytest.importorskip("gymnasium")
    ck = str(tmp_path / "g.bin")
    assert cli.main(GYM + argv + ["--save", ck]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Epoch: 0") and "J:" in out
    assert checkpoint.load(ck).cfg.env == "gym:Pendulum-v1"
    norm = "--obs-norm" in argv
    assert os.path.exists(ck + ".obsnorm.npz") == norm
    assert os.path.exists(ck + ".retnorm.npz") == norm
    assert cli.main(GYM + argv + ["--load", ck, "--eval-only"]) == 0
    assert capsys.readouterr().out.startswith("J:")


@pytest.mark.parametrize("argv,what", [
    (GYM + ["--solve-R", "0"], "host bridge"),
    (GYM + ["--import-ref", "x.bin"], "host bridge"),
    (GYM + ["--calibrate"], "--calibrate"),
    (GYM + ["--overlap", "--actor", "device"], "overlap=True requires"),
    (BASE + ["--obs-norm"], "--obs-norm/--reward-norm apply to gym"),
    (BASE + ["--reward-norm"], "--obs-norm/--reward-norm apply to gym"),
    (BASE + ["--overlap"], "--overlap (host actor"),
    (BASE + ["--sweep", "-1"], "positive seed count"),
    (BASE + ["--sweep", "2", "--save", "x.bin"], "do not apply"),
    (BASE + ["--sweep", "2", "--det-eval"], "do not apply"),
    (BASE + ["--sweep", "2", "--load", "x.bin"], "fresh on-device"),
    (GYM + ["--sweep", "2"], "fresh on-device"),
    (BASE + ["--sweep", "2", "--supervise", "2", "--save", "x.bin",
             "--checkpoint-every", "1"], "--supervise applies"),
    (BASE + ["--grid", "lr-policy"], "HP=V1,V2"),
    (BASE + ["--grid", "minibatch_size=32,64"], "not sweepable"),
    (BASE + ["--grid", "lr-policy=a,b"], "must be numbers"),
    (BASE + ["--grid", "lr-policy=1e-4", "--save", "x.bin"], "do not apply"),
    (BASE + ["--grid", "lr-policy=1e-4", "--mesh", "2"], "item 16"),
])
def test_host_bridge_and_sweep_guards(argv, what, capsys, on_cpu):
    """The JAX CLI's guards on the gym path, the normaliser and overlap
    flags and --sweep/--grid: each a parser error naming its reason (the
    JAX CLI exits on each of these argvs too, tests/test_sweep.py and
    tests/test_cli.py)."""
    pytest.importorskip("gymnasium")
    with pytest.raises((SystemExit, ValueError)) as e:
        cli.main(argv)
    if e.type is SystemExit:
        assert e.value.code == 2
        assert what in capsys.readouterr().err
    else:
        assert what in str(e.value)


@pytest.mark.parametrize("argv,lines", [
    (["--sweep", "2", "--solve-R=-1e9"], ["seed=1 solved=True epochs=1",
                                          "seed=2 solved=True epochs=1"]),
    (["--sweep", "2", "--n-epochs", "1"], ['{"seed": 1, "R": [',
                                           "final R over 2 seeds: mean="]),
    (["--grid", "lr-policy=1e-3,3e-4", "--solve-R=-1e9"],
     ["{'lr_policy': 0.001} seed=1 solved=True epochs=1", "best: "]),
    (["--grid", "clip-eps=0.1", "--sweep", "2", "--n-epochs", "1"],
     ['{"clip_eps": 0.1, "seed": 1, "R": [',
      '{"clip_eps": 0.1, "seed": 2, "R": [']),
])
def test_sweep_and_grid_print_the_jax_lines(argv, lines, capsys, on_cpu):
    """--sweep and --grid run one Trainer a lane (seeds from --seed) and
    print the JAX CLI's lines."""
    assert cli.main(BASE[:-2] + argv) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, out


def test_profile_writes_a_trace(tmp_path, capsys, on_cpu):
    d = str(tmp_path / "prof")
    assert cli.main(BASE + ["--n-epochs", "1", "--profile", d]) == 0
    assert "profiler trace written to" in capsys.readouterr().err
    assert any(f.endswith(".json") for f in os.listdir(d))


def test_supervise_restarts_until_success(tmp_path):
    ck = str(tmp_path / "ck.bin")
    calls = []

    def runner(argv):
        calls.append(list(argv))
        if len(calls) == 1:
            return 98                       # crash before any checkpoint
        if len(calls) == 2:
            open(ck, "wb").write(b"x")      # a checkpoint, then preempted
            return supervisor.PREEMPTED_EXIT
        return 0

    rc = supervisor.supervise(["first"], ["restart"], ck, max_restarts=5,
                              backoff_s=0, runner=runner, log=lambda m: None)
    assert rc == 0
    assert calls == [["first"], ["first"], ["restart"]]


def test_supervise_gives_up_after_max_restarts(tmp_path):
    ck = str(tmp_path / "ck.bin")
    open(ck, "wb").write(b"x")
    calls = []

    def runner(argv):
        calls.append(1)
        return 7

    rc = supervisor.supervise(["a"], ["b"], ck, max_restarts=3,
                              backoff_s=0, runner=runner, log=lambda m: None)
    assert rc == 7 and len(calls) == 4   # the first run + 3 restarts


def test_supervise_flag_runs_the_loop(tmp_path, monkeypatch, on_cpu):
    """--supervise hands the child argv without --supervise, and the
    restart argv, to supervisor.supervise."""
    seen = {}

    def fake(first, restart, path, max_restarts):
        seen.update(first=first, restart=restart, path=path,
                    n=max_restarts)
        return 0

    monkeypatch.setattr(supervisor, "supervise", fake)
    ck = str(tmp_path / "ck.bin")
    argv = BASE + ["--save", ck, "--checkpoint-every", "1", "--supervise",
                   "3"]
    assert cli.main(argv) == 0
    assert seen["first"] == BASE + ["--save", ck, "--checkpoint-every", "1"]
    assert seen["restart"][-2:] == ["--resume", ck] and seen["n"] == 3


def _run_cli(args, **extra_env):
    env = dict(os.environ, PYTHONPATH=REPO, PPOC_PLATFORM="cpu")
    env.pop("PPOC_FAULT_EPOCH", None)
    env.update(extra_env)
    return subprocess.run([sys.executable, "-m", "ppoc_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_fault_drill_end_to_end(tmp_path, on_cpu):
    """``python -m ppoc_tpu_torch --supervise``: the child is hard-killed
    right after global epoch 2's checkpoint (PPOC_FAULT_EPOCH=2), the
    supervisor restarts it with --resume, which finishes the original
    3-epoch schedule without firing the drill again; the result equals an
    uninterrupted in-process run bit for bit."""
    ck = str(tmp_path / "sup.bin")
    args = BASE + ["--save", ck, "--checkpoint-every", "1"]
    r = _run_cli(args + ["--supervise", "2"], PPOC_FAULT_EPOCH="2")
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "restart 1/2 (resuming from checkpoint)" in r.stderr
    assert "completed after 1 restart" in r.stderr
    got = checkpoint.load(ck)
    assert got.meta["epochs_done"] == 3

    straight = str(tmp_path / "straight.bin")
    assert cli.main(BASE + ["--save", straight, "--jsonl"]) == 0
    want = checkpoint.load(straight)
    assert_leaves_equal(got.state, want.state)
    assert torch.equal(got.generator, want.generator)
