"""Conformance-vector emission (L6).

Turns the dual-use scenario corpus (testing/cases, yield protocol) into the
cross-client YAML suites of the reference's test-format contract
(consensus-specs specs/test_formats/README.md:104-188 — suite header
fields, runner/handler directory nesting). The reference implements this as
seven standalone generators with a shared gen_runner
(consensus-specs test_libs/gen_helpers/gen_base/); here one package holds
the suite builders and a single CLI fans out over them.
"""
