"""Start the ranks of one process group as subprocesses of this host and
wait for them all.

Each rank writes its output to a file of its own: a pipe that nobody reads
can fill and stall its rank inside a collective, and the other ranks with it.
The ranks fail as a whole: a non-zero return code of any rank, or the time
limit, kills the others and raises with every rank's output.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import tempfile
import time
from contextlib import contextmanager

import torch.distributed as dist

__all__ = ["free_port", "one_rank_group", "run_ranks", "result_of"]

RESULT = "RESULT "


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextmanager
def one_rank_group(backend: str):
    """A process group of this process alone, destroyed on exit: the
    sharded paths' collectives run on it with one rank."""
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_ranks(argv, world: int, *, timeout: float, env=None, cwd=None) -> list[str]:
    """Run `argv(rank, coordinator)` (a command line) for each rank of a
    world of `world`, where coordinator is "127.0.0.1:<a free port>".
    Returns each rank's output (stdout and stderr) once all have exited 0;
    raises RuntimeError if one exits otherwise or `timeout` seconds pass."""
    coordinator = f"127.0.0.1:{free_port()}"
    failure = None
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen(argv(r, coordinator), stdout=logs[r], stderr=subprocess.STDOUT,
                                  stdin=subprocess.DEVNULL, env=env, cwd=cwd)
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while failure is None:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    break
                if any(c not in (None, 0) for c in codes):
                    failure = f"a rank failed: return codes {codes}"
                elif time.monotonic() > deadline:
                    failure = f"the ranks did not end within {timeout} s: return codes {codes}"
                else:
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failure:
        tails = "\n".join(f"--- rank {r}, return code {p.returncode}:\n{out[-6000:]}"
                          for r, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{failure}\n{tails}")
    return outs


def result_of(output: str) -> dict:
    """The JSON object a rank printed on its last line that starts with
    'RESULT '."""
    lines = [ln for ln in output.splitlines() if ln.startswith(RESULT)]
    if not lines:
        raise RuntimeError(f"the rank printed no result:\n{output[-4000:]}")
    return json.loads(lines[-1][len(RESULT):])
