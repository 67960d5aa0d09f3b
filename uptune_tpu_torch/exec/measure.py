"""Subprocess measurement with timeout kill and resource limits.

The spec is the reference's `call_program`
(`python/uptune/api.py:857-907` and
`opentuner/measurement/interface.py:231-346`): run the user program in
its own process group, enforce a wall-clock limit by SIGTERM-then-SIGKILL
of the whole group, optionally cap address space via setrlimit, and
report (returncode, stdout, stderr, wall time, timed_out).

The controller's process holds a CUDA context and, with an async
surrogate, a refit thread running CUDA work while it launches trials.
Running Python code in the forked child before `exec` (``preexec_fn``)
is what Python documents as unsafe in a threaded parent: the child may
block on a lock some other thread held at the fork.  So a child gets its
own session through ``start_new_session=True`` (a `setsid` done by
`subprocess` itself, in C), and ``preexec_fn`` runs only to cap the
address space when a memory limit is asked for.
"""
from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import Any, Dict, Optional


def _preexec(memory_limit: Optional[int]):
    """Child-side setup before `exec`: the optional memory cap
    (interface.py:309-325 preexec_setpgid_setrlimit), or None when there
    is none; the child's own process group comes from `popen_kw`."""
    if not memory_limit:
        return None

    def setup():
        import resource
        resource.setrlimit(resource.RLIMIT_AS,
                           (memory_limit, memory_limit))
    return setup


def popen_kw(memory_limit: Optional[int]) -> Dict[str, Any]:
    """`subprocess.Popen` keywords for a trial: its own session and
    process group (so a kill reaches its whole tree), and `preexec_fn`
    only for a memory cap (see the module docstring)."""
    return {"start_new_session": True,
            "preexec_fn": _preexec(memory_limit)}


def kill_process_group(proc: subprocess.Popen,
                       grace_s: float = 2.0) -> None:
    """SIGTERM the child's whole process group, escalate to SIGKILL
    (api.py:893-900, interface.py:335-346 goodkillpg)."""
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.time() + grace_s
    while time.time() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.05)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def call_program(cmd, *, limit: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None,
                 memory_limit: Optional[int] = None,
                 capture: bool = True) -> Dict[str, Any]:
    """Run `cmd` (str -> shell, list -> exec) to completion or `limit`
    seconds; returns {'returncode', 'stdout', 'stderr', 'time',
    'timeout'}.  A timed-out run has returncode < 0 and timeout=True."""
    t0 = time.time()
    pipe = subprocess.PIPE if capture else None
    proc = subprocess.Popen(
        cmd, shell=isinstance(cmd, str), cwd=cwd, env=env,
        stdout=pipe, stderr=pipe, text=True, **popen_kw(memory_limit))
    timed_out = False
    try:
        out, err = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        timed_out = True
        kill_process_group(proc)
        out, err = (proc.communicate() if capture else ("", ""))
    return {"returncode": proc.returncode, "stdout": out or "",
            "stderr": err or "", "time": time.time() - t0,
            "timeout": timed_out}
