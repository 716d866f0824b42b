"""Host-side pieces of the port: the slice's configuration gates, the
copied constant tables, the native entropy build location and the P
step's refusals."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.config import check_slice  # noqa: E402
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LDP = dict(width=128, height=64, intra_period=-1, pred_structure=0,
           scene_change_detection=False)

# bench.py's run_vod_4k10 settings (at this file's small geometry):
# 10-bit hier-B at preset 6 with restoration and adaptive quantization
VOD = dict(qp=40, bit_depth=10, pred_structure=2, hierarchical_levels=3,
           compound_mode=1, enc_mode=6, enable_restoration=True,
           enable_adaptive_quantization=True, recon_output=False)

GATES = [
    ("enable_warped_motion", dict(enable_warped_motion=True)),
    ("IBC", dict(screen_content_mode=1)),
    ("enable_film_grain", dict(enable_film_grain=10)),
    ("look_ahead_distance>0 with pred_structure=2",
     dict(pred_structure=2, look_ahead_distance=4)),
]


@pytest.mark.parametrize("label,extra", GATES, ids=[g[0] for g in GATES])
def test_unsupported_config_raises_by_name(label, extra):
    cfg = EncoderConfig(**{**LDP, **extra})
    with pytest.raises(NotImplementedError, match=label.split()[0]):
        check_slice(cfg)


@pytest.mark.parametrize("extra", [{}, dict(intra_period=-2),
                                   dict(intra_period=5),
                                   dict(enable_global_motion=False),
                                   dict(interp_filter=2),
                                   dict(enable_cdef=False,
                                        enable_deblocking=False),
                                   dict(pred_structure=2, compound_mode=0),
                                   dict(pred_structure=2, compound_mode=1,
                                        hierarchical_levels=2),
                                   dict(pred_structure=1),
                                   dict(tile_columns_log2=1),
                                   dict(scene_change_detection=True),
                                   dict(look_ahead_distance=4),
                                   dict(pred_structure=2,
                                        scene_change_detection=True),
                                   dict(enc_mode=7),
                                   dict(multi_ref=1),
                                   dict(bit_depth=10),
                                   dict(enable_adaptive_quantization=1),
                                   dict(enable_restoration=True),
                                   dict(pred_structure=2,
                                        enable_adaptive_quantization=2),
                                   VOD,
                                   dict(intra_period=-2, device_batch=4),
                                   dict(intra_period=3, num_gop_shards=2),
                                   # presets 0-5 and rate control 1-3
                                   dict(enc_mode=5), dict(enc_mode=0),
                                   dict(rate_control_mode=1,
                                        target_bit_rate=1000),
                                   dict(rate_control_mode=2,
                                        target_bit_rate=1000),
                                   dict(rate_control_mode=3,
                                        target_bit_rate=1000,
                                        pred_structure=2)])
def test_slice_configs_pass(extra):
    check_slice(EncoderConfig(**{**LDP, **extra}))


def test_default_config_is_all_intra_and_allowed():
    check_slice(EncoderConfig(width=64, height=64))


@pytest.mark.parametrize("kw", [dict(compound=True, nrefs=1), dict(nrefs=4),
                                dict(filters=False)])
def test_p_frame_step_refuses_unported_variants(kw):
    with pytest.raises(NotImplementedError):
        TPE.p_frame_step(64, 64, 16, 16, **kw)


@pytest.mark.parametrize("kw", [dict(bd=10), dict(lr=True), dict(aq=True),
                                dict(bd=10, rdo=True, nrefs=3,
                                     compound=True, lr=True, aq=True),
                                # presets <= 5 (without rdo: ignored, as
                                # in the reference)
                                dict(rdo=True, txs=True),
                                dict(rdo=True, rect=True), dict(txs=True)])
def test_p_frame_step_builds_ported_variants(kw):
    assert callable(TPE.p_frame_step(64, 64, 16, 16, **kw))


def test_tables_are_copies_of_the_reference():
    ref = ROOT / "svt_av1_tpu" / "tables" / "data"
    port = ROOT / "svt_av1_tpu_torch" / "tables" / "data"
    with np.load(ref / "av1_tables.npz") as a, \
            np.load(port / "av1_tables.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    assert json.loads((ref / "txfm_stages.json").read_text()) == \
        json.loads((port / "txfm_stages.json").read_text())


def test_entropy_library_builds_outside_the_package():
    from svt_av1_tpu_torch.entropy import backend
    from svt_av1_tpu_torch.utils import build
    if not backend.available():
        pytest.skip("no C++ compiler")
    lib = Path(backend._lib()._name)
    assert lib.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "svt_av1_tpu_torch")
    assert not list((ROOT / "svt_av1_tpu_torch").rglob("*.so"))


def test_config_fields_match_the_reference():
    pytest.importorskip("jax")
    from svt_av1_tpu.config import EncoderConfig as JConfig
    names = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert names(EncoderConfig) == names(JConfig)
