"""Run the PyTorch half of the port tests in a child process.

The port tests compare the PyTorch port (denoise_gan_tpu_torch) with the JAX
package.  The workers of this suite hold TensorFlow and JAX, and they
segfault now and then (a known fault of this mix, seen in JAX's garbage
collection).  So that the port tests do not load torch into every worker
as well, no test module of the port imports torch: each starts one spawned
child process
(:func:`torch_process`), which imports torch and the port, and calls the
functions of ``tests/torch_side.py`` there.  Arguments and results are numpy
arrays and plain Python values; an exception raised in the child is raised
again in the test.  The child ends itself within a second of its parent's
death, so a worker that crashes leaves no torch process behind.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import importlib.util
import multiprocessing
import os
import threading
import time

import pytest

TIMEOUT_S = 600     # one call; the slowest takes well under a minute on CPU
PARENT_POLL_S = 1.0  # how often the child checks that its parent lives


def skip_without_torch() -> None:
    """Skip the calling test module when torch is not installed, without
    importing it."""
    if importlib.util.find_spec("torch") is None:
        pytest.skip("torch is not installed", allow_module_level=True)


def _exit_with_parent(parent: int) -> None:
    """In the child, at its start: a daemon thread that ends the process
    once its parent ``parent`` is gone (the child is then re-parented)."""
    def watch() -> None:
        while os.getppid() == parent:
            time.sleep(PARENT_POLL_S)
        os._exit(1)

    threading.Thread(target=watch, name="exit-with-parent",
                     daemon=True).start()


def _run(name: str, args: tuple, kwargs: dict):
    """In the child: torch_side.<name>(*args, **kwargs)."""
    return getattr(importlib.import_module("torch_side"), name)(*args,
                                                                **kwargs)


@contextlib.contextmanager
def torch_process():
    """Yield ``call(name, *args, **kwargs)``, which runs
    ``torch_side.<name>`` in one spawned child process and returns its
    result."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=ctx, initializer=_exit_with_parent,
            initargs=(os.getpid(),)) as pool:
        def call(name: str, *args, **kwargs):
            return pool.submit(_run, name, args, kwargs).result(TIMEOUT_S)

        yield call
