"""Port parity at 10 bits, preset 8, 192x128, for the two-reference
structures: hierarchical B with compound prediction and low-delay B,
at qp 0, 40 and 63, against svt_av1_tpu on the CPU (TUs byte-identical
in decode order, the mirror decoder reproduces the port's recon); and
the int16 level container of the P step at 10 bits, qindex 1, where a
64x64 level exceeds int16: both packages wrap it alike."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from test_torch_tenbit import W, H, clip10  # noqa: E402


@pytest.mark.parametrize("qp", [0, 40, 63])
def test_hierb_compound_10bit_equals_reference(qp):
    """A keyframe and one levels-2 mini-GOP (base P + compound B)."""
    kw = dict(width=W, height=H, qp=qp, bit_depth=10, intra_period=-1,
              pred_structure=2, hierarchical_levels=2, compound_mode=1,
              interp_filter=0, scene_change_detection=False,
              recon_output=True)
    tus = encode_both(kw, clip10(5))
    coded = [p for p in tus if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 4, 2, 1, 3]
    assert all(p.recon.y.dtype == np.uint16 for p in coded)
    assert_decodes_to_recon(tus)


@pytest.mark.parametrize("qp", [0, 40, 63])
def test_ldb_10bit_equals_reference(qp):
    kw = dict(width=W, height=H, qp=qp, bit_depth=10, intra_period=-1,
              pred_structure=1, scene_change_detection=False,
              recon_output=True)
    tus = encode_both(kw, clip10(4))
    assert [p.is_keyframe for p in tus] == [True, False, False, False]
    assert tus[1].recon.y.dtype == np.uint16
    assert_decodes_to_recon(tus)


def test_p_step_level_wrap_10bit_qindex1():
    """A black source over a white reference at qindex 1 (every
    prediction is 1023): each flat 64x64 leaf's DC level, -58195, does
    not fit the int16 level output;
    the reference casts it (XLA convert: two's-complement wrap) and the
    port's .to(torch.int16) wraps it the same way.  Both packages then
    code the wrapped level while their recon keeps the true one, so
    such a stream would not decode to the encoder's recon: a fault of
    the reference that the port reproduces to stay byte-identical.  The
    step is built as the reference encoder builds the hier-B base step
    above (one compile)."""
    import jax.numpy as jnp

    from svt_av1_tpu.pipeline import inter_encoder as JPE
    from svt_av1_tpu_torch.ops import quant as TQ
    from svt_av1_tpu_torch.ops import transforms as TT
    from svt_av1_tpu_torch.pipeline import inter_encoder as TPE

    n = 64
    src = [np.zeros((H, W), np.uint16),
           np.full((H // 2, W // 2), 512, np.uint16),
           np.full((H // 2, W // 2), 512, np.uint16)]
    ref = [np.full((H, W), 1023, np.uint16)] + src[1:]
    geo = (H, W, H // 4, W // 4)
    jfn = JPE.build_p_frame_encoder_dyn(*geo, cdef=True, bd=10, rdo=False,
                                        txs=False, filt=0, lr=False,
                                        rect=False, aq=False)
    want = jfn(*(jnp.asarray(p) for p in src + ref), jnp.int32(1),
               jnp.int32(0), jnp.int32(0), jnp.int32(0))
    tfn = TPE.build_p_frame_encoder_dyn(*geo, cdef=True, bd=10)
    got = tfn(*(torch.from_numpy(p.astype(np.int16)) for p in src + ref),
              1, 0, 0, 0)
    for i in range(9):
        assert np.array_equal(np.asarray(want[i]).astype(np.int32),
                              got[i].numpy().astype(np.int32)), i
    assert (got[0] == 64).all()                  # 64x64 leaves
    dc = TQ.quantize_batch(TT.fwd_txfm2d_batch(
        torch.full((1, n, n), -1023, dtype=torch.int32), TT.TX_64X64,
        TT.DCT_DCT, 10), 1, TT.TX_64X64, 10)[0, 0, 0]
    assert int(dc) == -58195
    assert int(got[2][0, 0, 0, 0]) == -58195 + 65536
