"""The yield-protocol test wrapper.

Capability parity: consensus-specs test_libs/pyspec/eth2spec/test/utils.py:
6-85 — the reference's single most reusable design idea (SURVEY.md §4): a
spec test is a generator function yielding named artifacts, consumed two
ways. Under pytest the artifacts are drained and dropped (the asserts in
the test body are the point); with `generator_mode=True` the same run is
captured into a dict that becomes one YAML conformance-vector case.

Artifact protocol (shared with generators/from_tables.py): each yield is
`(key, value)` or `(key, value, ssz_type)`; a `None` value records an
explicit null (the "no post state" convention for invalid-input cases).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, Optional

from ..debug.encode import encode
from ..utils.ssz.typing import Container


class CaseRecorder:
    """Accumulates one test run's yielded artifacts into a vector case."""

    def __init__(self, description: str):
        self.fields: Dict[str, Any] = {"description": description}
        self.count = 0

    def record(self, artifact) -> None:
        self.count += 1
        if len(artifact) == 3:
            key, value, typ = artifact
            self.fields[key] = None if value is None else encode(value, typ)
        else:
            key, value = artifact
            # untyped yields: SSZ containers self-describe; anything else
            # passes through raw (the yielder owns its YAML representation)
            self.fields[key] = (encode(value, value.__class__)
                                if isinstance(value, Container) else value)

    def case(self) -> Optional[Dict[str, Any]]:
        """None when the run yielded nothing — no artifacts, no case."""
        return self.fields if self.count else None


def _default_description(fn: Callable) -> str:
    name = fn.__name__
    return name[len("test_"):] if name.startswith("test_") else name


def spectest(description: Optional[str] = None):
    """Wrap a yielding spec test for its two consumers (see module doc)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if kw.pop("generator_mode", False) is not True:
                for _ in fn(*args, **kw):   # pytest: drain, keep only asserts
                    pass
                return None
            recorder = CaseRecorder(description or _default_description(fn))
            for artifact in fn(*args, **kw):
                recorder.record(artifact)
            return recorder.case()
        return wrapper
    return deco


def with_tags(tags: Dict[str, Any]):
    """Stamp constant annotations (e.g. the bls_setting vector key) onto
    generator-mode output; pytest-mode (None) passes through untouched.
    Yielded fields win over tags on key collision."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            case = fn(*args, **kw)
            return None if case is None else {**tags, **case}
        return wrapper
    return deco


def with_args(make_args: Callable[[], Iterable[Any]]):
    """Prepend freshly-built positional arguments on every invocation."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            return fn(*make_args(), *args, **kw)
        return wrapper
    return deco
