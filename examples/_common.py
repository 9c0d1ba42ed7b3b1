"""Shared example-script plumbing: platform selection + argparse."""

from __future__ import annotations

import argparse


def parse_args(description: str, **extra_flags):
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--platform",
        default="cpu",
        choices=["cpu", "gpu", "default"],
        help="JAX platform: cpu (portable default), gpu (fails if no card "
        "is found), or default (leave jax.config untouched)",
    )
    for flag, (typ, default, help_) in extra_flags.items():
        p.add_argument(f"--{flag}", type=typ, default=default, help=help_)
    args = p.parse_args()

    import jax

    from griduniverse_tpu.utils.compile_cache import enable_compile_cache

    if args.platform == "cpu":
        # CPU runs (and the tests that drive the examples) keep no cache
        jax.config.update("jax_platforms", "cpu")
        return args
    if args.platform == "gpu":
        # keep the CPU backend too: the Gym-style envs pin to it
        jax.config.update("jax_platforms", "cuda,cpu")
        if jax.devices()[0].platform != "gpu":
            raise SystemExit("--platform gpu: no GPU found")
    enable_compile_cache()
    return args
