"""Best-effort repro for the host XLA-CPU compile segfault.

Observed failure (2026-08-21/22, FOUR times, jax==0.9.0 jaxlib==0.9.0 on
this 2-core linux box): running the FULL test suite in one pytest
process, a late pjit COMPILE segfaults inside XLA (`pxla.py` compile
frame, SIGSEGV, 66-86% through the suite, after ~270-300 distinct
compiled programs had accumulated). Victims: twice
tests/test_td_lambda.py's prediction test; the third sighting (r5,
after test_td_lambda gained its guard) hit tests/test_td_batched.py;
the fourth (r5, after a guarded-module LIST was tried) hit
tests/test_perenv_levels.py — i.e. the crash follows the
accumulated-state position in the collection order, not a specific
program, and a per-module guard cannot converge. Mitigation in tree: a
global bound on accumulation — tests/conftest.py
`_bounded_compile_cache` drops the jit caches every
`_CACHE_CLEAR_EVERY` tests, keeping the live program count well under
the ~300-program trigger.

This script recreates the suspected trigger state directly: it compiles
N distinct small pjit programs (varying shapes so each is a fresh
compile), then compiles and runs the td_lambda prediction program that
crashed. Run it as its own process and read the exit code:

    timeout 1200 python tools/xla_cpu_segfault_repro.py --programs 350
    echo $?     # 0 = survived (no repro); <0/139 = segfault reproduced

Status: at the default 350 programs this script has NOT reproduced the
crash on the observed toolchain — the suite's real compile mix
(shard_map programs, conv trunks, while_loops) is evidently part of the
trigger. The guard therefore stays keyed to the OBSERVED toolchain
version: tests/test_td_lambda.py::test_workaround_toolchain_canary
fails loudly when jax/jaxlib change so the workaround is re-evaluated
(rerun the full suite once with the fixture disabled) instead of
outliving the bug silently.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp


def accumulate_programs(n: int) -> None:
    """Compile n distinct tiny programs (distinct shapes → distinct
    cache entries), mimicking a long pytest session's compiler state."""
    for i in range(n):
        k = 2 + (i % 61)

        @jax.jit
        def f(x, _k=k):
            return jnp.sin(x) @ jnp.ones((_k, 3)) + i

        f(jnp.ones((4, k))).block_until_ready()
        if (i + 1) % 50 == 0:
            print(f"  compiled {i + 1}/{n} programs", flush=True)


def crash_site() -> None:
    """The program whose compile segfaulted under the full suite."""
    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.algos import td_lambda_prediction
    from griduniverse_tpu.levels.builders import lava_level

    sem = make_semantics()
    level = lava_level()
    s = level.grid.shape[-2] * level.grid.shape[-1]
    policy = jnp.full((s, 4), 0.25, jnp.float32)
    res = td_lambda_prediction(
        sem, level, policy, jax.random.PRNGKey(0),
        num_steps=200, batch_size=32,
    )
    jax.block_until_ready(res.v)
    print(f"crash-site program compiled and ran: v[0]={float(res.v[0]):.3f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--programs", type=int, default=350)
    args = ap.parse_args()
    import jaxlib

    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"accumulating {args.programs} distinct compiles ...", flush=True)
    accumulate_programs(args.programs)
    print("compiling the crash-site program ...", flush=True)
    crash_site()
    print("SURVIVED — no repro at this program count/mix")


if __name__ == "__main__":
    main()
