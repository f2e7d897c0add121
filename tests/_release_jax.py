"""Autouse fixture for the port's differential tests (tests/test_torch_*.py).

Those modules run JAX reference functions at many shapes, and a JAX process
keeps every program it compiled until ``jax.clear_caches()``. Under
pytest-xdist one worker runs many modules in turn and holds the programs of
all of them: a worker that ran the pairing suites holds several GiB. So each
port module drops the compiled programs, its own and those of the modules
that ran before it on the same worker, when it starts and when it ends, and
hands the freed heap back to the OS. A later test that needs a program
compiles it again.

Import the fixture by name into a test module to use it:
``from _release_jax import release_jax_programs  # noqa: F401``."""
import ctypes
import gc

import jax
import pytest


def _release():
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass    # not glibc: the freed heap stays with the process


@pytest.fixture(autouse=True, scope="module")
def release_jax_programs():
    _release()
    yield
    _release()
