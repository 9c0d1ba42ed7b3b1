"""chip_smoke.py's phases at tiny sizes on the CPU.

On the card each phase runs at the size users run; here the same code
paths, comparisons and checks run at shapes that take seconds, so a broken
phase shows before any chip time is spent. The script's own entry point
must refuse to run without a GPU.
"""

import pytest

import chip_smoke as cs
from griduniverse_tpu import make_semantics

SEM = make_semantics()

TINY = {
    "step": lambda: cs.phase_step(
        SEM, n_envs=64, n_steps=50, n_check_envs=16, n_check_steps=40,
        n_oracle_envs=2, max_episode_steps=8,
    ),
    "mazes": lambda: cs.phase_mazes(n_mazes=32, cells=(3, 3), n_check=8),
    "vi": lambda: cs.phase_vi(SEM, n_mazes=32, cells=(2, 2), n_check=8),
    "vi_canary": lambda: cs.phase_vi_canary(
        SEM, shapes=(((2, 2), 64), ((3, 3), 32)), n_check=8
    ),
    "qlearn_fast": lambda: cs.phase_qlearn_fast(
        SEM, n_envs=64, n_steps=20, n_spread=5, max_episode_steps=8
    ),
    "ppo": lambda: cs.phase_ppo(
        SEM, n_envs=64, n_updates=2, max_episode_steps=8
    ),
    "ppo_mazes": lambda: cs.phase_ppo_mazes(
        SEM, n_mazes=32, n_updates=2, cells=(2, 2), max_episode_steps=8
    ),
    "dqn": lambda: cs.phase_dqn(
        SEM, n_envs=64, n_steps=20, capacity=512, max_episode_steps=8
    ),
    "sharded": lambda: cs.phase_sharded(
        SEM, n_devices=4, n_envs=64, q_steps=20, n_mazes=32, ppo_updates=2,
        n_rollout_envs=64, rollout_steps=30, max_episode_steps=8,
    ),
}


def test_every_main_phase_has_a_tiny_case():
    assert {name for name, _ in cs.ONE_CARD_PHASES} | {"sharded"} == set(TINY)


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_passes_at_tiny_size(phase):
    result = TINY[phase]()
    assert "check" in result


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert cs.main(argv) != 0
    out = capsys.readouterr()
    assert "needs a GPU" in out.err
    assert '"ok"' not in out.out


def test_failed_check_raises():
    with pytest.raises(cs.CheckFailed, match="boom"):
        cs.check(False, "boom")
