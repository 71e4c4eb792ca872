"""Run a port test's worker code as the ranks of one ``gloo`` group on
the CPU: each rank a subprocess of ``python -c code rank world store
*args``, the group started from a ``file://`` store in the test's own
directory (no port to race for between xdist workers), each under its own
time limit."""
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT_S = 280


def run_ranks(code: str, world: int, tmp_path, *args) -> list:
    """Run ``code`` as ``world`` processes (rank, world, the store path and
    ``args`` in ``sys.argv``); returns each rank's stdout.  Every rank must
    exit 0 within RANK_TIMEOUT_S."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(store),
         *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return outs
