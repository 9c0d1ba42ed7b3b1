"""Smoke tests: every example script runs end-to-end with tiny args.

SURVEY.md §2.1 #9: docs/PARITY.md claims the
examples are runnable; this proves it on every CI run. Each script runs in
a subprocess (its own interpreter — examples do their own platform
selection) on CPU with arguments shrunk until the run is a few seconds.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"

# script → tiny-args override (every script accepts --platform cpu)
TINY_ARGS = {
    "01_gym_style_random_walk.py": ["--steps", "5"],
    "02_value_iteration.py": [],
    "03_q_learning_vectorized.py": ["--envs", "64", "--steps", "200"],
    "04_procedural_mazes.py": ["--envs", "16", "--cells", "3", "--steps", "64"],
    "05_multihost_sharded.py": ["--envs", "64", "--steps", "100"],
    "06_fast_engine.py": [
        "--envs", "64", "--steps", "500", "--train_steps", "200",
    ],
    "07_ppo.py": ["--updates", "3", "--envs", "16"],
    "08_dqn.py": ["--steps", "150", "--envs", "16"],
    "09_multiprocess.py": [
        "--procs", "2", "--devices_per_proc", "2",
        "--steps", "100", "--envs", "64",
    ],
    "10_traces_per_gridobs.py": [
        "--envs", "16", "--td_steps", "300", "--dqn_steps", "150",
        "--ppo_updates", "3",
    ],
    "11_maze_generalization.py": [
        "--mazes", "32", "--eval_mazes", "8", "--updates", "3",
        "--channels", "8", "--hidden", "16",
    ],
    "12_sharded_checkpoint_resume.py": [
        "--envs", "16", "--chunks", "2", "--updates_per_chunk", "2",
        "--ckpt_dir", "/tmp/gu_ci_ex12_ckpt", "--fresh", "1",
    ],
    "13_fresh_maze_curriculum.py": [
        "--mazes", "32", "--eval_mazes", "8", "--chunks", "2",
        "--updates_per_chunk", "2", "--channels", "8", "--hidden", "16",
    ],
}


def _example_scripts():
    found = sorted(p.name for p in EXAMPLES.glob("[0-9]*.py"))
    # keep TINY_ARGS exhaustive: a new example must get a smoke entry
    assert found == sorted(TINY_ARGS), (
        f"examples/ and TINY_ARGS disagree: {found} vs {sorted(TINY_ARGS)}"
    )
    return found


@pytest.mark.parametrize("script", _example_scripts())
def test_example_runs(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # the multihost example wants >1 device; give every script the same
    # virtual 4-device CPU platform (examples force --platform cpu anyway)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        .replace("--xla_force_host_platform_device_count=8", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    proc = subprocess.run(
        [sys.executable, script, "--platform", "cpu", *TINY_ARGS[script]],
        cwd=EXAMPLES,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"{script} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr ---\n{proc.stderr[-2000:]}"
    )
