"""Hierarchical B at the RD presets against svt_av1_tpu on the CPU.

At preset 6 multi-reference prediction is on (multi_ref=-1): an interior
frame of a mini-GOP whose references are not the span's base adds the
base as a third single-prediction reference (LAST, BWDREF, ALTREF), so
a levels-3 mini-GOP codes display 1, 2, 3 and 5 from three references.
A 9-frame stream (keyframe + one mini-GOP) must give TUs byte-identical
to the reference encoder's in decode order, with the mirror decoder
reproducing the port's recon.  The RD steps alone (one reference; two
and three with compound prediction) must give the reference steps'
outputs on references with strong noise over different thirds of the
picture.  Preset 7 with multi_ref=0 (two references only) and the CLI
at --preset 7 must be byte-identical too; they reuse this file's
compiled reference steps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import (assert_decodes_to_recon,  # noqa: E402
                           assert_same_tus, check_hierb_config,
                           run_both_clis, write_yuv)
from _torch_rd import W, H, check_step  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu import EncoderConfig as JConfig  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline.encoder import Encoder as JEncoder  # noqa: E402
from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402

N = 9
HIERB6 = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=2,
              hierarchical_levels=3, compound_mode=1, enc_mode=6,
              scene_change_detection=False, recon_output=True)


@pytest.fixture(scope="module")
def runs():
    frames = [synthetic_frame(W, H, seed=60 + i) for i in range(N)]
    jenc = JEncoder(JConfig(**HIERB6))
    want = list(jenc.encode_all(frames))
    tenc = Encoder(EncoderConfig(**HIERB6), device="cpu")
    got = list(tenc.encode_all(frames))
    return want, got, jenc, tenc


def test_hierb_preset6_tus_byte_identical(runs):
    want, got, jenc, tenc = runs
    assert_same_tus(want, got)
    coded = [p for p in got if p.recon is not None]
    assert [p.display_idx for p in coded] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert coded[0].leaf16_cells
    assert tenc._nrefs3_frames == getattr(jenc, "_nrefs3_frames", 0) == 4
    assert sum(p.compound_cells for p in coded[2:]) > 0


def test_hierb_preset6_mirror_decoder_reproduces_port_recon(runs):
    assert_decodes_to_recon(runs[1])


@pytest.mark.parametrize("nrefs", [1, 2, 3])
def test_rd_step_equals_reference(runs, nrefs):
    filt = runs[3]._interp_filt
    out = check_step(nrefs, nrefs > 1, filt, (160, 60))
    assert len(np.unique(out["sizes"])) >= 3
    if nrefs > 1:
        # every reference and the compound average win somewhere
        assert set(np.unique(out["ref8"])) == set(range(nrefs + 1))


def test_multi_ref_off_preset7_byte_identical():
    coded = check_hierb_config(dict(enc_mode=7, multi_ref=0), 5,
                               [0, 4, 2, 1, 3])
    assert coded[0].leaf16_cells


def test_cli_hierb_preset7_files_byte_identical(tmp_path):
    write_yuv(tmp_path / "in.yuv", W, H, 5)
    got = run_both_clis(tmp_path, [
        "-w", str(W), "-h", str(H), "-q", "40", "--intra-period", "-1",
        "--pred-struct", "2", "--hierarchical-levels", "2", "--preset", "7",
        "--stat-report"])
    assert len(got["rec"]) == 5 * W * H * 3 // 2
