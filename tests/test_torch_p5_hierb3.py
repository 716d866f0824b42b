"""The three-reference B step at presets <= 5 against svt_av1_tpu on the
CPU: LAST, BWDREF and ALTREF with the compound candidate of the first
two, the tx-type search and rect leaves, whose halves inherit a child's
reference choice (any of the three, or the compound average).  On
references with strong noise over different thirds of the picture, at
two q, every output must equal the reference step's (built as a hier-B
interior frame of a levels >= 2 span builds it)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_rd import check_step  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")


@pytest.mark.parametrize("q", [60, 160])
def test_three_ref_step_txs_rect_equals_reference(q):
    out = check_step(3, True, 0, (q,), p5=True)
    if q == 60:
        assert (out["shape8"] > 0).any() and (out["txty"] == 9).any()
        assert set(np.unique(out["ref8"])) == {0, 1, 2, 3}
