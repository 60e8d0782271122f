"""Multi-host entry points: distributed init, cross-process arrays,
process launcher.

The reference is strictly single-process (std::thread pool,
src/GoblinThreadPool.cpp); the multi-host scaling story (SURVEY.md §2.9)
is a jax.distributed mesh spanning hosts: every host runs the same
program, `jax.devices()` is the *global* device list, and the `rays`
mesh axis simply spans hosts — film reduction and gradient sums are
collectives inserted by XLA. Nothing in the render code changes; what
this module adds is the process bootstrap:

- init_from_env(): call jax.distributed.initialize from GOBLIN_* env
  vars (no-op when unset, so single-process use is unaffected)
- global_put(): device_put that also works when the sharding spans
  processes (each process contributes its addressable shards)
- launch_local(): spawn N local processes with the right env for an
  N-way CPU mesh — a CPU-only test stand-in for one process per host.
  On GPUs every script runs as one process per card, never several
  processes on one card.
"""

from __future__ import annotations

import os
import subprocess
import sys


def init_from_env() -> bool:
    """Initialize jax.distributed from env. Returns True when a
    multi-process runtime was set up.

    Env: GOBLIN_COORDINATOR=host:port, GOBLIN_NUM_PROCS, GOBLIN_PROC_ID.
    Where the cluster runtime tells JAX its layout, plain
    jax.distributed.initialize() (no args) also works; set
    GOBLIN_DIST=auto for that path.
    """
    import jax

    if os.environ.get("GOBLIN_DIST") == "auto":
        jax.distributed.initialize()
        return True
    coord = os.environ.get("GOBLIN_COORDINATOR")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["GOBLIN_NUM_PROCS"]),
        process_id=int(os.environ["GOBLIN_PROC_ID"]),
    )
    return True


def global_put(arr, sharding):
    """device_put an array onto a (possibly process-spanning) sharding.

    Single-process: plain device_put. Multi-process: each process
    provides the shards it can address via make_array_from_callback —
    `arr` must hold the same global value on every process (true for our
    host-side pixel-id/valid arrays, which are derived from static scene
    config)."""
    import jax
    import numpy as np

    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def launch_local(n_procs: int, argv: list[str], port: int = 7723,
                 devices_per_proc: int = 4, env_extra=None):
    """Spawn n_procs local processes, each a goblin process with
    GOBLIN_* distributed env + devices_per_proc fake CPU devices — a
    CPU-only test stand-in for one process per host (JAX_PLATFORMS=cpu
    is forced: several processes must not share a GPU). Returns the
    list of completed subprocess results."""
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env.update(env_extra or {})
        env["GOBLIN_COORDINATOR"] = f"localhost:{port}"
        env["GOBLIN_NUM_PROCS"] = str(n_procs)
        env["GOBLIN_PROC_ID"] = str(pid)
        env["JAX_PLATFORMS"] = "cpu"
        import re

        flags = re.sub(
            r"--xla_force_host_platform_device_count=\d+", "",
            env.get("XLA_FLAGS", ""),
        )
        env["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={devices_per_proc}"
        ).strip()
        procs.append(
            subprocess.Popen(
                [sys.executable] + argv, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        results.append((p.returncode, out))
    return results
