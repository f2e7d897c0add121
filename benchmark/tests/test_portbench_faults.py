"""A whole run on the CPU, with the harness's look for a card skipped and
the timed path broken underneath, must come out not correct: for each
fault a cell can have on one chip (a step that returns its state
unchanged; half of a batch left out, the rest's answers copied over it;
half of the attestations dropped by staging, so that they are never
submitted; an answer altered where it is produced). The exchange between
chips does not exist on one chip. The same run unbroken comes out
correct."""
import pytest
import torch

from benchmark.harness import run_cell


def _run(bench, cell):
    return run_cell(bench, cell, 2 ** 31 + 11, 0.0, False, device="cpu")


def _pairing_fault(kind):
    from consensus_specs_tpu_torch.ops import bls_torch as BT
    real = BT.grouped_pairing_check

    def broken(g1, g2, *a, **k):
        if kind == "half":
            h = max(1, g1.shape[0] // 2)
            ok = real(g1[:h], g2[:h], *a, **k)
            return torch.cat([ok, ok])[:g1.shape[0]]
        ok = real(g1, g2, *a, **k).clone()
        ok[0] = ~ok[0]
        return ok
    return broken


def _staging_drops_half(real):
    def broken(self, st):
        real(self, st)
        del st.groups[len(st.groups) // 2:]
    return broken


@pytest.mark.parametrize("fault", ["sound", "unchanged", "half", "staging_drops_half",
                                   "altered"])
def test_gossip_faults_come_out_not_correct(bench, monkeypatch, fault):
    from consensus_specs_tpu_torch.ops import bls_torch as BT
    from consensus_specs_tpu_torch.streaming import pipeline
    if fault == "unchanged":      # the ring keeps what it held
        monkeypatch.setattr(pipeline.FirehosePipeline, "_scatter",
                            lambda self, verdicts, start: self.ring)
    elif fault == "staging_drops_half":
        monkeypatch.setattr(BT.TorchBackend, "stage_pairs",
                            _staging_drops_half(BT.TorchBackend.stage_pairs))
    elif fault != "sound":
        monkeypatch.setattr(BT, "grouped_pairing_check", _pairing_fault(fault))
    out = _run(bench, "tiny.gossip")
    assert out["correct"] is (fault == "sound"), out["checks"]
    if fault == "staging_drops_half":
        assert out["checks"]["verdicts_missing"]["value"] > 0 and out["failed"] > 0
