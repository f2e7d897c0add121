"""On the card: the tiny cell runs through the hand kernels and comes out
correct. Skips without a card."""
import pytest

from benchmark.harness import run_cell


@pytest.mark.chip
def test_tiny_cell_on_the_card(bench, card):
    out = run_cell(bench, "tiny.gossip", 2 ** 31 + 17, 1.0, True, device=str(card))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
