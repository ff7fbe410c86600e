"""On the card: a tiny cell of each loop through the program's kernels,
held to the reference (``python -m pytest portbench/tests -m cuda`` on the
card)."""

from __future__ import annotations

import pytest

from conftest import (SERVE, TRAIN, assert_sound_serving, run_cell,
                      tiny_serve, tiny_train)


@pytest.mark.cuda
def test_tiny_training_on_the_card(card):
    conf, tr = tiny_train()
    _, line = run_cell(TRAIN, conf, tr, card, seconds=1.0, trace=True)
    assert line['correct'], line['checks']
    assert line['device']['busy_s'] > 0


@pytest.mark.cuda
def test_tiny_serving_on_the_card(card):
    conf, tr = tiny_serve()
    _, line = run_cell(SERVE, conf, tr, card, seconds=1.0, trace=True)
    assert_sound_serving(line)
    assert line['device']['busy_s'] > 0
