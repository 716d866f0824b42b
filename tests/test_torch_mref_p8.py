"""multi_ref=1 at preset 8 against svt_av1_tpu on the CPU: the fast
(preset-8) step runs with a third reference on the interior frames of a
hier-B mini-GOP whose references are not the span's base; that
reference runs its own quarter-res HME (no mirrored centres) and joins
the per-cell reference choice.  TUs must be byte-identical in decode
order, with the mirror decoder reproducing the port's recon."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import HIERB, W, H  # noqa: E402
from _torch_parity import (assert_decodes_to_recon,  # noqa: E402
                           assert_same_tus, drive)
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402

KW = dict(HIERB, multi_ref=1, hierarchical_levels=3)


@pytest.fixture(scope="module")
def runs():
    frames = [synthetic_frame(W, H, seed=60 + i) for i in range(9)]
    jenc = JEncoder(JConfig(**KW))
    tenc = Encoder(EncoderConfig(**KW), device="cpu")
    return drive(jenc, frames), drive(tenc, frames), jenc, tenc


def test_multi_ref_on_preset8_byte_identical(runs):
    want, got, jenc, tenc = runs
    assert_same_tus(want, got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert coded[0].leaf16_cells is None      # preset 8: 8x8 wavefront
    assert tenc._nrefs3_frames == getattr(jenc, "_nrefs3_frames", 0) == 4


def test_multi_ref_on_preset8_mirror_decoder_reproduces_port_recon(runs):
    assert_decodes_to_recon(runs[1])
