"""The gloo ranks of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_spatial.py), forked from one
process that imports their code once.

    python tests/torch_ranks.py MODULE WORLD [ARGS...]

imports ``MODULE`` (a rank's code, e.g. ``tests._torch_spatial_child``,
with torch and the port), then forks ``WORLD`` processes, rank r calling
``MODULE.main(r, WORLD, ARGS)``, and exits with the first non-zero exit
code of its ranks. Started as interpreters of their own, the ranks would
each import the same code again (~5 CPU-seconds apiece); forked, they share
the launcher's. The launcher starts no thread before the fork: it runs with
one OpenMP and BLAS thread, and a rank sets torch's own count.

A test module starts the ranks with :func:`start` (in a session of their
own, so that :func:`stop` ends every one of them), and :func:`wait` returns
their log once the launcher exited 0 and every rank printed ``[r] DONE``.
"""

import importlib
import os
import signal
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def start(module: str, world: int, *args) -> subprocess.Popen:
    """The launcher of ``world`` ranks of ``module``, running."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, str(Path(__file__)), module, str(world),
         *(str(a) for a in args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def wait(proc: subprocess.Popen, world: int, timeout: float = 600) -> str:
    """The ranks' log, once each of them ended well."""
    log = proc.communicate(timeout=timeout)[0]
    assert proc.returncode == 0 and all(
        f"[{r}] DONE" in log for r in range(world)), log[-6000:]
    return log


def stop(proc: subprocess.Popen) -> None:
    """End the launcher and its ranks, if they still run."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def _launch(module: str, world: int, args: list) -> int:
    sys.path.insert(0, str(ROOT))
    mod = importlib.import_module(module)
    pids = []
    for rank in range(world):
        pid = os.fork()
        if pid == 0:
            code = 1
            try:
                mod.main(rank, world, args)
                code = 0
            except BaseException:  # noqa: BLE001 (the exit code says it)
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        pids.append(pid)
    rc = 0
    for pid in pids:
        _, status = os.waitpid(pid, 0)
        rc = rc or os.waitstatus_to_exitcode(status)
    return rc


if __name__ == "__main__":
    sys.exit(_launch(sys.argv[1], int(sys.argv[2]), sys.argv[3:]))
