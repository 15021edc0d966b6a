"""The port tests' child process (tests/torch_process.py) ends when the
process that started it dies, so a crashed test worker leaves no torch
process running behind it."""

import os
import signal
import subprocess
import sys
import textwrap
import time

from torch_process import PARENT_POLL_S, skip_without_torch

skip_without_torch()

TESTS = os.path.dirname(os.path.abspath(__file__))


def _alive(pid: int) -> bool:
    """Whether the process runs: it exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_child_exits_when_its_parent_is_killed():
    """A parent that starts the child, then dies by SIGKILL (no clean-up
    runs, as in a segfault) leaves a child that ends within a few polls."""
    code = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {TESTS!r})
        from torch_process import torch_process
        with torch_process() as call:
            print(call("process_id"), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
    """)
    parent = subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
    child = int(parent.stdout.readline())
    assert parent.wait(60) == -signal.SIGKILL
    assert child != parent.pid
    deadline = time.monotonic() + 10 * PARENT_POLL_S
    while _alive(child) and time.monotonic() < deadline:
        time.sleep(0.1)
    alive = _alive(child)
    if alive:
        os.kill(child, signal.SIGKILL)
    assert not alive, "the child outlived its parent"
