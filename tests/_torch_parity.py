"""Shared checks of the port's hier-B parity tests: two TU streams are
equal byte for byte in decode order, with the same timing fields and
equal recon on every coded TU; and one hier-B config encoded at 192x128
by both packages gives such streams."""

import numpy as np

W, H = 192, 128
HIERB = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
             hierarchical_levels=2, compound_mode=1,
             scene_change_detection=False, recon_output=True)


def assert_same_tus(want, got):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.payload == b.payload, f"TU {i}"
        assert (a.pts, a.show, a.display_idx, a.is_keyframe) == \
            (b.pts, b.show, b.display_idx, b.is_keyframe), f"TU {i}"
        assert (a.recon is None) == (b.recon is None), f"TU {i}"
        if a.recon is not None:
            for p in ("y", "u", "v"):
                assert np.array_equal(getattr(a.recon, p),
                                      getattr(b.recon, p)), f"TU {i} {p}"


def check_hierb_config(extra, n, order):
    """Encode n seeded frames under HIERB + extra through svt_av1_tpu's
    Encoder and the port's (on the CPU); the TUs must be equal, and the
    coded frames must come in the display order `order`, with one
    show-existing TU for every coded frame that is not a keyframe."""
    from svt_av1_tpu import EncoderConfig as JConfig
    from svt_av1_tpu.io.yuv import synthetic_frame
    from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    kw = {**HIERB, **extra}
    frames = [synthetic_frame(W, H, seed=60 + i) for i in range(n)]
    want = list(JEncoder(JConfig(**kw)).encode_all(frames))
    got = list(Encoder(EncoderConfig(**kw), device="cpu").encode_all(frames))
    assert_same_tus(want, got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == order
    assert len(got) == 2 * n - sum(p.is_keyframe for p in coded)
    return coded
