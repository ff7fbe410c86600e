"""The pair-key training parity tests of
``tests/test_torch_pairkeys_train.py`` on its STPLS3D-like model section
(``with_coords`` off, ``semantic_weight``, ``match_low_quality`` with
``min_pos_thr``, relative class-size thresholds), in a file of its own so
that its JAX compilation runs beside the S3DIS-like one.  Tolerances:
that file's.
"""

import pytest

# collected here, on this file's fixture
from test_torch_pairkeys_train import (  # noqa: F401
    _slice, test_pair_key_adam_step, test_pair_key_batch_stats,
    test_pair_key_gradients, test_pair_key_losses)


@pytest.fixture(scope='module')
def stepped():
    return 'stpls3d', _slice('stpls3d')
