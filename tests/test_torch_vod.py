"""Port parity of bench.py's 4K 10-bit VOD configuration (run_vod_4k10:
hier-B at levels 3 with compound prediction, preset 6 with its third
reference, loop restoration and adaptive quantization) against
svt_av1_tpu on the CPU, at 200x136: a width that is not a multiple of
64, so partial superblocks, restoration units and stripes are hit.  The
nine frames are bench.py's clip construction (one seeded 10-bit
picture, luma rolled by (2i, 3i)).  TUs must be byte-identical in decode
order and the reference's mirror decoder must reproduce the port's
recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from _torch_parity import (assert_decodes_to_recon,  # noqa: E402
                           assert_same_tus, drive)
from test_torch_tenbit import clip10  # noqa: E402

W, H, N = 200, 136, 9
# bench.py:185's EncoderConfig, at W x H
VOD = dict(width=W, height=H, qp=40, bit_depth=10, intra_period=-1,
           pred_structure=2, hierarchical_levels=3, compound_mode=1,
           enc_mode=6, enable_restoration=True,
           enable_adaptive_quantization=True, recon_output=False,
           scene_change_detection=False)


def test_vod_config_equals_reference():
    from svt_av1_tpu import EncoderConfig as JConfig
    from svt_av1_tpu.decoder import Decoder
    from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    frames = clip10(N, w=W, h=H)
    want = drive(JEncoder(JConfig(**VOD)), frames)
    enc = Encoder(EncoderConfig(**VOD), device="cpu")
    got = drive(enc, frames)
    assert_same_tus(want, got)
    assert_decodes_to_recon(got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert all(p.recon.y.dtype == np.uint16 for p in coded)
    # the preset-6 tools ran: 16x16 keyframe leaves, three-reference
    # interior frames (display 1, 2, 3, 5), compound cells
    assert coded[0].leaf16_cells > 0
    assert enc._nrefs3_frames == 4
    assert sum(p.compound_cells or 0 for p in coded) > 0
    # restoration switched units on, and AQ moved some inter frame's q
    # off its layer q (the keyframe anchor takes none)
    dec, restored = Decoder(), 0
    for p in got:
        dec.decode_temporal_unit(p.payload)
        if p.recon is not None and dec.lr is not None:
            restored += sum(int(pl["use"].sum()) for pl in dec.lr
                            if pl is not None)
    assert restored > 0
    plain = drive(Encoder(EncoderConfig(**dict(
        VOD, enable_adaptive_quantization=False)), device="cpu"), frames)
    q_plain = {p.display_idx: p.qindex for p in plain if p.recon is not None}
    assert any(p.qindex != q_plain[p.display_idx] for p in coded[1:])
