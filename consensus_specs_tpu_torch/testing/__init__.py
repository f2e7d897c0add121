"""Dual-use test framework: pytest runner AND conformance-vector source.

Test functions yield named artifacts; under pytest the yields are drained,
under generator mode they are encoded into a YAML test case — the reference's
single most reusable design (eth2spec/test/utils.py + context.py).
"""
