"""A pytest plugin that reports what each test module leaves behind in
the process that ran it: after the module's last test, the garbage is
collected, then the resident memory, the objects the collector tracks,
the JAX arrays alive and whether torch is imported are printed.  A
diagnostic for the suite's workers (one module after another in one
process, as a worker of ``--dist loadfile`` runs them); not a test::

    PYTHONPATH=tests python -m pytest -p worker_memory -p no:randomly \\
        tests/test_a.py tests/test_b.py
"""

from __future__ import annotations

import gc
import sys

import pytest

_rows: list[str] = []


def _rss_mb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) // 1024
    return -1


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    yield
    if nextitem is not None and nextitem.path == item.path:
        return
    gc.collect()
    jax = sys.modules.get("jax")
    live = len(jax.live_arrays()) if jax is not None else 0
    _rows.append(f"{item.path.name}: rss {_rss_mb()} MB, gc objects "
                 f"{len(gc.get_objects())}, live JAX arrays {live}, torch "
                 f"{'imported' if 'torch' in sys.modules else 'absent'}")


def pytest_terminal_summary(terminalreporter):
    terminalreporter.section("memory after each module")
    for row in _rows:
        terminalreporter.write_line(row)
