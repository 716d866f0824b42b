"""Port parity of adaptive quantization against svt_av1_tpu on the CPU
(mirrors tests/test_delta_q.py): level 1, a frame q offset from picture
analysis, on hier-B, IPPP and low-delay B; level 2, which adds the
per-superblock qindex map on hier-B inter frames (residual quantization
per SB on the device, delta-q coded per SB).  TUs must be byte-identical
in decode order and the mirror decoder must reproduce the port's
recon."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402

W, H = 192, 128
# the regular filter fixed, so the step test below reuses the encoder
# tests' reference compile
HIERB = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
             hierarchical_levels=2, compound_mode=1, interp_filter=0,
             scene_change_detection=False, recon_output=True)


def mixed_clip(n):
    """Half flat / half busy frames (tests/test_delta_q.py's clip): the
    variance map is bimodal, so the qindex map carries real deltas."""
    from svt_av1_tpu.io.yuv import synthetic_frame

    rng = np.random.default_rng(7)
    base = synthetic_frame(W, H, seed=3)
    base.y[:, : W // 2] = 64
    base.y[:, W // 2:] = rng.integers(0, 256, (H, W - W // 2))
    out = []
    for i in range(n):
        f = synthetic_frame(W, H, seed=3)
        f.y[:] = np.roll(base.y, (i, 2 * i), (0, 1))
        out.append(f)
    return out


def _delta_q_frames(tus):
    """Frames whose header signals delta_q, read by the mirror decoder."""
    from svt_av1_tpu.decoder import Decoder

    dec, n = Decoder(), 0
    for p in tus:
        dec.decode_temporal_unit(p.payload)
        if p.recon is not None and getattr(dec, "fp", None) is not None \
                and dec.fp.delta_q_res:
            n += 1
    return n


def _coded_q(kw, frames):
    """{display index: qindex} of the port's coded frames."""
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.pipeline.encoder import Encoder

    enc = Encoder(EncoderConfig(**kw), device="cpu")
    return {(i if p.display_idx is None else p.display_idx): p.qindex
            for i, p in enumerate(enc.encode_all(frames))
            if p.recon is not None}


@pytest.mark.parametrize("aq", [1, 2])
def test_aq_hierb_equals_reference(aq):
    kw = dict(HIERB, enable_adaptive_quantization=aq)
    frames = mixed_clip(7)
    tus = encode_both(kw, frames)
    assert_decodes_to_recon(tus)
    # the frame offset moved some inter frame's q off its layer q
    with_aq, without = _coded_q(kw, frames), _coded_q(HIERB, frames)
    assert with_aq[0] == without[0]       # the keyframe anchor: no AQ
    assert any(with_aq[d] != without[d] for d in with_aq)
    n_dq = _delta_q_frames(tus)
    assert (n_dq > 0) if aq == 2 else (n_dq == 0)


@pytest.mark.parametrize("structure", [0, 1], ids=["ippp", "ldb"])
def test_aq1_flat_structures_equal_reference(structure):
    """The flat structures offset every frame's q, keyframes included."""
    kw = dict(width=W, height=H, qp=40, intra_period=-1,
              pred_structure=structure, enable_adaptive_quantization=1,
              scene_change_detection=False, recon_output=True)
    tus = encode_both(kw, mixed_clip(3))
    assert_decodes_to_recon(tus)
    assert any(p.qindex != 160 for p in tus)


def test_aq2_step_qmap_equals_reference():
    """The hier-B base P step with a per-SB qindex map: every output
    equal, and the map changes the levels against the frame q.  Built
    with the keywords the reference encoder passes (one compile with
    test_aq_hierb_equals_reference[2])."""
    import jax.numpy as jnp

    from svt_av1_tpu.pipeline import inter_encoder as JPE
    from svt_av1_tpu_torch.pipeline import inter_encoder as TPE
    from svt_av1_tpu_torch.pipeline.intra_encoder import pad_plane

    f0, f1 = mixed_clip(2)
    ph, pw = H, W
    planes = lambda f: (pad_plane(f.y, ph, pw),
                        pad_plane(f.u, ph // 2, pw // 2),
                        pad_plane(f.v, ph // 2, pw // 2))
    src, ref = planes(f1), planes(f0)
    qmap = np.array([[120, 200, 160], [90, 160, 230]], np.int32)
    geo = (ph, pw, H // 4, W // 4)
    jfn = JPE.build_p_frame_encoder_dyn(*geo, cdef=True, bd=8, rdo=False,
                                        txs=False, filt=0, lr=False,
                                        rect=False, aq=True)
    want = jfn(*(jnp.asarray(p) for p in src + ref), jnp.int32(160),
               jnp.int32(20), jnp.int32(10), jnp.int32(10),
               jnp.asarray(qmap))
    tfn = TPE.build_p_frame_encoder_dyn(*geo, cdef=True, bd=8, aq=True)
    args = [torch.from_numpy(np.ascontiguousarray(p)) for p in src + ref]
    got = tfn(*args, 160, 20, 10, 10, torch.from_numpy(qmap))
    for i in range(9):
        assert np.array_equal(np.asarray(want[i]), got[i].numpy()), i
    flat = TPE.build_p_frame_encoder_dyn(*geo, cdef=True, bd=8)(
        *args, 160, 20, 10, 10)
    assert not torch.equal(flat[2], got[2])
