"""The port's own PPOConfig copy (ppoc_tpu_torch/config.py) against the JAX
package's config module: the same fields and defaults, the same presets,
and validate accepting and rejecting the same configs with the same
message.  Exact comparisons: these are plain Python values.
"""
import dataclasses

import pytest

from ppoc_tpu import config as jconfig
from ppoc_tpu_torch import config

JBASE = jconfig.PPOConfig(env="simple", n_envs=8, rollout_len=15,
                          minibatch_size=16, eval_envs=8, eval_len=15,
                          hidden=(16, 16))

# the invalid configs of tests/test_errors.py's shared-validator test, plus
# one for each other check of validate
BAD = [
    dict(minibatch_size=10_000),
    dict(rnn_hidden=4, attn_dim=4),
    dict(attn_dim=4, n_experts=2),
    dict(rnn_hidden=4, reset_per_fit=False),
    dict(rnn_hidden=4, rnn_cell="elman"),
    dict(attn_dim=6, attn_heads=4),
    dict(tp_size=2, pp_size=2),
    dict(zero1=True, n_experts=4, ep_size=2),
    dict(ep_size=2),
    dict(ep_size=2, n_experts=3),
    dict(n_experts=2, tp_size=2),
    dict(pp_size=2),
    dict(eval_estimator="median"),
    dict(shuffle_block=-1),
    dict(shuffle_block=7),
    dict(shuffle_block=8, rnn_hidden=4),
    dict(transplant_patience=3),
    dict(transplant_patience=-1),
    dict(transplant_patience=3, rnn_hidden=4, zero1=True),
    dict(aux_value_coeff=0.5),
    dict(aux_value_coeff=-0.5),
    dict(aux_value_coeff=0.5, attn_dim=4, sp_size=3),
    dict(fit_dispatch="eager"),
    dict(fit_dispatch="phased"),
    dict(fit_dispatch="phased", rnn_hidden=4, reset_per_fit=False),
    dict(fit_dispatch="phased", rnn_hidden=4, fits_per_program=1),
    dict(fit_dispatch="phased", rnn_hidden=4, tp_size=2),
    dict(rollout_chunk=-1),
    dict(rollout_chunk=5),
    dict(rollout_chunk=4, fit_dispatch="phased", rnn_hidden=4),
    dict(fits_per_program=-1),
    dict(fits_per_program=3),
    dict(fits_per_program=1, zero1=True),
    dict(sp_size=2),
    dict(sp_size=2, attn_dim=4),
    dict(sp_size=3, attn_dim=4, zero1=True),
    dict(zero1=True, tp_size=2),
]
GOOD = [dict(), dict(shuffle_block=8), dict(eval_estimator="reference"),
        dict(rnn_hidden=4, fit_dispatch="phased", rollout_chunk=5),
        dict(fits_per_program=5), dict(attn_dim=4, sp_size=3)]


def test_fields_and_defaults_match_the_jax_config():
    mine = [(f.name, f.default) for f in dataclasses.fields(config.PPOConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(jconfig.PPOConfig)]
    assert mine == theirs
    cfg, jcfg = config.PPOConfig(), jconfig.PPOConfig()
    for prop in ("steps_per_fit", "num_minibatches", "steps_per_epoch"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)
    assert cfg.replace(n_envs=3).steps_per_fit == 600


@pytest.mark.parametrize("preset", ["reference_preset", "tpu_preset",
                                    "tuned_preset"])
def test_presets_match_the_jax_presets(preset):
    for env, seed in (("pendulum", 0), ("cartpole", 3)):
        assert dataclasses.asdict(getattr(config, preset)(env, seed)) == \
            dataclasses.asdict(getattr(jconfig, preset)(env, seed))


@pytest.mark.parametrize("kw", BAD + GOOD)
def test_validate_agrees_with_the_jax_bank(kw):
    jcfg = JBASE.replace(**kw)
    cfg = config.PPOConfig(**dataclasses.asdict(jcfg))
    try:
        jconfig.validate(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            config.validate(cfg)
        assert str(mine.value) == str(e)
        assert kw in BAD
    else:
        assert config.validate(cfg) is cfg
        assert kw in GOOD
