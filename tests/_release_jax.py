"""Autouse fixtures for the port's differential tests (tests/test_torch_*.py).

`torch_one_thread` runs each such module's torch work on one intra-op
thread. The tensors are small, and under pytest-xdist several workers
share the cores: each worker's default pool of one thread per core then
oversubscribes them. Six copies of one grouped-pairing test at once on 8
cores took 282 s each with the default pool and 10 s with one thread; one
copy alone takes about the same either way. The count in force before the
module is restored after it.

`release_jax_programs`: those modules run JAX reference functions at many
shapes, and a JAX process keeps every program it compiled until
``jax.clear_caches()``. Under
pytest-xdist one worker runs many modules in turn and holds the programs of
all of them: a worker that ran the pairing suites holds several GiB. So each
port module drops the compiled programs, its own and those of the modules
that ran before it on the same worker, when it starts and when it ends, and
hands the freed heap back to the OS. A later test that needs a program
compiles it again.

Import the fixtures by name into a test module to use them:
``from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401``."""
import ctypes
import gc

import jax
import pytest
import torch


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


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
