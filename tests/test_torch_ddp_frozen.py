"""Parity of the port's data parallelism with the reference's mesh step
in the frozen-backbone mode of the recipe (``fixed_modules``: the stage-2
step), on the CPU: two gloo ranks against ``make_train_step(mesh=
make_mesh(2), frozen_modules=...)``, with the checks and tolerances of
``tests/test_torch_ddp.py`` (its own file so that the reference's second
compilation runs beside the first under xdist).
"""

import numpy as np
import pytest

from test_torch_ddp import BACKBONE, _reference, _run_pair
from torch_helpers import tiny_data


@pytest.fixture(scope='module')
def reference():
    return _reference()


def test_two_rank_step_frozen_backbone(reference, tmp_path):
    """(b) The frozen-backbone mode: the reference's mesh step; the frozen
    parameters and the frozen batch norms' buffers bit-identical to the
    initial ones on both ranks, none of them reduced."""
    state, ranks = _run_pair(reference, tmp_path,
                             [[tiny_data(1), tiny_data(2)]], frozen=True)
    for rec in (ranks[0][0], ranks[1][0]):
        frozen = [k for k in rec['params'] if k.split('.')[0] in BACKBONE]
        assert frozen and not any(k in rec['grads'] for k in frozen)
        for k in frozen:
            np.testing.assert_array_equal(rec['params'][k], state[k])
        frozen_bufs = [k for k in rec['buffers']
                       if k.split('.')[0] in BACKBONE]
        assert frozen_bufs
        for k in frozen_bufs:
            np.testing.assert_array_equal(rec['buffers'][k], state[k])
        assert not any(n.split('.')[0] in BACKBONE
                       for n in rec['train_norms'])
