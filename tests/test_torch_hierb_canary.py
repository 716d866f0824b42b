"""Hierarchical-B parity at the 854x480 canary (a width that is not a
multiple of 64 and above 512): a keyframe and one 4-frame mini-GOP with
compound prediction from the port equal svt_av1_tpu's TUs byte for
byte, with equal recon and PSNR."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402


def test_canary_854x480_hierb_byte_identical():
    kw = dict(width=854, height=480, qp=40, intra_period=-1,
              pred_structure=2, hierarchical_levels=2, compound_mode=1,
              scene_change_detection=False, recon_output=True,
              stat_report=True)
    frames = [synthetic_frame(854, 480, seed=50 + i) for i in range(5)]
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert len(got) == len(want) == 9
    assert [p.payload for p in got] == [p.payload for p in want]
    for a, b in zip(want, got):
        assert (a.pts, a.show, a.display_idx) == \
            (b.pts, b.show, b.display_idx)
        if a.recon is not None:
            assert np.allclose(a.psnr, b.psnr)
            for p in ("y", "u", "v"):
                assert np.array_equal(getattr(a.recon, p),
                                      getattr(b.recon, p))
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 4, 2, 1, 3]
    assert sum(p.compound_cells for p in coded[2:]) > 0
    assert all(25.0 < p.psnr[0] < 50.0 for p in coded)
