"""`python_bls`: both packages sign and verify through their bignum
"python" BLS backend for one test. The port's default ("torch") is put
back by name afterwards, since selecting it would build the CUDA backend.

Import it by name into a test module that uses it:
``from _bls_backend import python_bls  # noqa: F401``."""
import pytest

from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu_torch.crypto import bls as PBLS


@pytest.fixture
def python_bls():
    j_old = JBLS._active_backend_name
    PBLS.set_backend("python")
    JBLS.set_backend("python")
    try:
        yield
    finally:
        PBLS._active_backend_name = "torch"
        JBLS._active_backend_name = j_old
