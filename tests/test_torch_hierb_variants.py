"""Hierarchical-B parity at 192x128 with compound prediction off
(compound_mode=0: every interior frame picks the forward or the
backward reference per cell): TUs must equal svt_av1_tpu's byte for
byte in decode order, with equal recon, and no cell is compound."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_same_tus  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402

W, H = 192, 128


def test_hierb_compound_off_byte_identical():
    kw = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
              hierarchical_levels=3, compound_mode=0,
              scene_change_detection=False, recon_output=True)
    frames = [synthetic_frame(W, H, seed=40 + i) for i in range(9)]
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert len(got) == len(want) == 17
    assert_same_tus(want, got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert [p.compound_cells for p in coded] == [None, None] + [0] * 7
