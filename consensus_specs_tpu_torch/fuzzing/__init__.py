"""Fuzzing bridge: an independent SSZ codec for differential decoding.

The reference bridges its spec types to the external `pyssz` library and
round-trips random objects through both decoders
(consensus-specs test_libs/pyspec/eth2spec/fuzzing/decoder.py:5-84,
fuzzing/test_decoder.py). No external SSZ library ships in this image, so
the bridge target here is `sedes.py` — a second, independently written
codec (descriptor objects with their own parsing loop, sharing nothing
with utils/ssz/impl.py) that random objects round-trip through both ways.
"""
from .decoder import translate_type, translate_value  # noqa: F401
