"""Low-delay-B parity at 192x128: every frame after the keyframe is coded
by the two-reference step without compound prediction, from LAST (the
previous frame) and GOLDEN (the keyframe), and shown at once.  The
port's TUs must equal svt_av1_tpu's byte for byte, with equal recon,
and the reference package's mirror decoder must reproduce the port's
recon.  Scene-change detection stays at its default (on); the seeded
frames hold no cut.  A periodic keyframe restarts GOLDEN and the slot
rule (LAST alternates between slots 1 and 2), which changes
refresh_frame_flags and ref_frame_idx in the headers that follow."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402

W, H, N = 192, 128, 8
LDB = dict(width=W, height=H, qp=40, intra_period=-1, pred_structure=1,
           recon_output=True)


def frames(n):
    return [synthetic_frame(W, H, seed=60 + i) for i in range(n)]


@pytest.fixture(scope="module")
def default_run():
    return encode_both(LDB, frames(N))


def test_ldb_tus_byte_identical(default_run):
    tus = default_run
    assert [p.is_keyframe for p in tus] == [True] + [False] * (N - 1)
    assert [(p.pts, p.display_idx, p.show) for p in tus] == \
        [(i, i, True) for i in range(N)]
    # the B frames coded no compound cell
    assert all(p.compound_cells == 0 for p in tus[1:])


def test_ldb_mirror_decoder_reproduces_port_recon(default_run):
    assert_decodes_to_recon(default_run)


# (id, config overrides, frames, keyframe positions)
CASES = [
    ("intra_period=5", dict(intra_period=5), 8, [0, 6]),
    ("qp0", dict(qp=0), 4, [0]),
    ("qp63", dict(qp=63), 4, [0]),
]


@pytest.mark.parametrize("extra,n,keys", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_ldb_config_byte_identical(extra, n, keys):
    tus = encode_both({**LDB, **extra}, frames(n))
    assert [i for i, p in enumerate(tus) if p.is_keyframe] == keys
    assert_decodes_to_recon(tus)
