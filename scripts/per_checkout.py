"""Run a timing script's worker once for each checkout, each in a process of
its own, and gather the JSON lines it prints.

A script such as ``k10_passes.py`` or ``planes_cases.py`` times the kernels
of one or more checkouts given in order (say ``build/parent . .
build/parent``, so that both versions meet the card's drift alike). ``run``
starts the script again with ``--worker`` and its arguments in each
checkout's directory in turn; ``worker_path`` puts that checkout first on
``sys.path``, so that the worker builds and runs that checkout's package,
and ``chip_smoke`` gives it this checkout's ``chip_smoke.py`` to build its
inputs and time them, whichever checkout is timed. Each JSON line a worker
prints is printed and appended to ``chiprun_out/<log>``.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module."""
    spec = importlib.util.spec_from_file_location("timed_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker_path() -> None:
    """Put the checkout the worker runs in first on ``sys.path``."""
    sys.path.insert(0, str(Path.cwd()))


def run(script: str, checkouts: list, worker_args: list, log: str) -> int:
    """``script --worker *worker_args`` in each checkout in order; 1 if any
    of them failed (its error's end on stderr), else 0."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    rc = 0
    with open(out / log, "a") as f:
        for co in checkouts:
            res = subprocess.run([sys.executable, str(Path(script).resolve()), "--worker",
                                  *worker_args],
                                 cwd=Path(co).resolve(), capture_output=True, text=True)
            for line in res.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    f.write(line + "\n")
            if res.returncode:
                print(f"{Path(script).name}: {co} failed:\n{res.stderr[-4000:]}",
                      file=sys.stderr)
                rc = 1
    return rc
