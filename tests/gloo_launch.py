"""Run a script in N processes joined by torch.distributed over gloo on
the CPU, for the port's multi-rank tests.

Each process runs `script` as `python script RANK WORLD STORE WORKDIR`,
where STORE is a file:// rendezvous in WORKDIR (no port to race for),
imports torch and the port only (never JAX), and writes what the test
compares into WORKDIR. start() returns at once, so the parent can compute
its JAX references while the ranks run; wait() joins them and fails with
every rank's output if one of them failed.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GlooRun:
    def __init__(self, script: str, workdir, world: int = 4):
        self.workdir = workdir
        path = os.path.join(workdir, "rank_script.py")
        with open(path, "w") as f:
            f.write(script)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        store = "file://" + os.path.join(os.path.abspath(workdir), "rendezvous")
        self.procs = [
            subprocess.Popen([sys.executable, path, str(rank), str(world), store,
                              str(workdir)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for rank in range(world)
        ]
        self._outputs = None

    def wait(self, timeout: float = 900.0):
        if self._outputs is None:
            try:
                self._outputs = [p.communicate(timeout=timeout)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            failed = [i for i, p in enumerate(self.procs) if p.returncode != 0]
            if failed:
                raise AssertionError("\n".join(
                    f"rank {i} exited {self.procs[i].returncode}:\n{self._outputs[i]}"
                    for i in failed))
        return self._outputs

    def close(self):
        """Kill any rank still running (a test that failed before wait())."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def start(script: str, workdir, world: int = 4) -> GlooRun:
    return GlooRun(script, workdir, world)
