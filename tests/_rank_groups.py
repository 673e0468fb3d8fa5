"""Groups of gloo rank processes for the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_tp.py, tests/test_torch_sp.py).

``RankGroups`` starts every rank of every group at once, each a worker
script run as

    python <worker> [<group>] <rank> <world> <init method> <out dir>

and waits for them, within one time limit from their start, on the first
result a test asks for. The ranks meet through a file in ``<out dir>``
(``file://`` rendezvous), not through a TCP port chosen in advance: a port
found free here and handed to a rank that binds it seconds later, under
the load of a parallel test run, can be taken in between by any other
process, and a group whose rank 0 cannot bind its store waits for it until
the limit. Each rank writes its output to ``<out dir>/log-<group>-<rank>``.

The outcome is decided once: the group fails as soon as one rank exits
with an error (the others are killed then, not at the limit) or when the
limit passes. The first test that waits reports every rank's output; any
later one fails with a line that points back to it, so that no test reads
the results of a group that did not finish.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

POLL_S = 0.2


class RankGroups:
    """``groups``: {name: world size}, ``None`` for one unnamed group (the
    worker then takes no group argument)."""

    def __init__(self, worker: Path, out: Path, groups: dict | None, world: int = 0,
                 limit_s: float = 300.0):
        self.out, self.limit_s = out, limit_s
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["OMP_NUM_THREADS"] = "1"
        self.start = time.monotonic()
        self.procs, self.logs = [], []
        for group, size in (groups or {None: world}).items():
            tag = group or "ranks"
            init = f"file://{out / f'rendezvous-{tag}'}"
            for rank in range(size):
                log = out / f"log-{tag}-{rank}"
                args = ([] if group is None else [group]) + [str(rank), str(size), init, str(out)]
                with open(log, "w") as f:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, str(worker), *args], stdout=f, stderr=subprocess.STDOUT,
                        env=env))
                self.logs.append((f"{tag} rank {rank}", log))
        self.failure: str | None = None
        self.reported = False
        self.done = False

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def _report(self, why: str) -> str:
        parts = [why]
        for (name, log), p in zip(self.logs, self.procs):
            text = log.read_text(errors="replace") if log.exists() else ""
            parts.append(f"--- {name} (exit {p.returncode}) ---\n{text[-4000:]}")
        return "\n".join(parts)

    def wait(self) -> None:
        """Return once every rank has exited 0; else fail the calling test
        (with the ranks' output the first time)."""
        while not self.done and self.failure is None:
            codes = [p.poll() for p in self.procs]
            bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            elapsed = time.monotonic() - self.start
            if bad:
                self.kill()
                self.failure = f"ranks failed {bad} after {elapsed:.0f} s; the others were killed"
            elif all(c == 0 for c in codes):
                self.done = True
            elif elapsed > self.limit_s:
                running = [i for i, c in enumerate(codes) if c is None]
                self.kill()
                self.failure = (f"the ranks exceeded their {self.limit_s:.0f}-s limit "
                                f"(processes {running} still running); all were killed")
            else:
                time.sleep(POLL_S)
        if self.failure is not None:
            if self.reported:
                pytest.fail(f"{self.failure} (their output is in the first failure of this "
                            "module)")
            self.reported = True
            pytest.fail(self._report(self.failure))
