"""Port parity at 10 bits, preset 8, 192x128: all-intra streams and
low-delay-P (IPPP) chains at qp 0, 40 and 63, and the 10-bit keyframe
wavefront step, against svt_av1_tpu on the CPU.  TUs must be
byte-identical in decode order, recon equal (numpy uint16), and the
reference's mirror decoder must reproduce the port's recon.
tests/test_torch_tenbit_b.py holds hier-B and low-delay B."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")

from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402

W, H = 192, 128


def clip10(n, seed=5, w=W, h=H):
    """bench.py's 10-bit VOD clip at w x h: one seeded 10-bit picture,
    luma rolled by (2i, 3i) in frame i."""
    from svt_av1_tpu.io.yuv import synthetic_frame

    base = synthetic_frame(w, h, seed=seed, bit_depth=10)
    out = []
    for i in range(n):
        f = synthetic_frame(w, h, seed=seed, bit_depth=10)
        f.y[:] = np.roll(base.y, (2 * i, 3 * i), (0, 1))
        out.append(f)
    return out


def _check_10bit(tus):
    coded = [p for p in tus if p.recon is not None]
    assert coded and all(p.recon.y.dtype == np.uint16 for p in coded)
    assert max(int(p.recon.y.max()) for p in coded) > 255
    assert_decodes_to_recon(tus)


@pytest.mark.parametrize("qp", [0, 40, 63])
def test_all_intra_10bit_equals_reference(qp):
    kw = dict(width=W, height=H, qp=qp, bit_depth=10, stat_report=True)
    tus = encode_both(kw, clip10(2))
    _check_10bit(tus)
    assert all(p.is_keyframe for p in tus)


@pytest.mark.parametrize("qp", [0, 40, 63])
def test_ippp_10bit_equals_reference(qp):
    """One keyframe and three P frames (global motion on); qp 0 is
    qindex 1, where the 10-bit level caps are widest."""
    kw = dict(width=W, height=H, qp=qp, bit_depth=10, intra_period=-1,
              pred_structure=0, scene_change_detection=False,
              recon_output=True, stat_report=True)
    tus = encode_both(kw, clip10(4))
    _check_10bit(tus)
    assert [p.is_keyframe for p in tus] == [True, False, False, False]


@pytest.mark.parametrize("qindex", [1, 160, 255])
def test_keyframe_step_10bit_equals_reference(qindex):
    """The 8x8 wavefront at bd=10: every output, the int16 recon
    container against the reference's uint16 recon."""
    import jax.numpy as jnp

    from svt_av1_tpu.pipeline import intra_encoder as JIE
    from svt_av1_tpu_torch.pipeline import intra_encoder as TIE

    f = clip10(1)[0]
    nbh, nbw = H // 8, W // 8
    blocks = (TIE.block_planes(f.y, 8), TIE.block_planes(f.u, 4),
              TIE.block_planes(f.v, 4))
    want = JIE.build_frame_encoder_dyn(nbh, nbw, 10, rich=False,
                                       part16=False, ibc=False)(
        *(jnp.asarray(b) for b in blocks), jnp.int32(qindex))
    got = TIE.frame_step(*(torch.from_numpy(b.astype(np.int16))
                           for b in blocks), qindex, 10)
    assert got[4].dtype == torch.int16
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(a).astype(np.int32),
                              b.numpy().astype(np.int32)), i


def _write_yuv10(path, frames, packed: bool):
    """Frames as raw 10-bit 4:2:0: little-endian uint16 samples, or the
    compressed-ten-bit layout (8-bit MSB planes, then 2-bit LSB planes
    packed four to a byte, MSB first)."""
    with open(path, "wb") as fh:
        for f in frames:
            if not packed:
                for pl in (f.y, f.u, f.v):
                    fh.write(pl.astype("<u2").tobytes())
                continue
            planes = (f.y, f.u, f.v)
            for pl in planes:
                fh.write((pl >> 2).astype(np.uint8).tobytes())
            for pl in planes:
                l4 = (pl & 3).astype(np.uint8).reshape(pl.shape[0], -1, 4)
                fh.write(((l4[..., 0] << 6) | (l4[..., 1] << 4)
                          | (l4[..., 2] << 2) | l4[..., 3]).tobytes())


@pytest.mark.parametrize("packed", [False, True],
                         ids=["yuv10", "compressed_ten_bit"])
def test_cli_10bit_files_byte_identical(tmp_path, packed):
    """--bit-depth 10 (and --compressed-ten-bit 1) through both CLIs on
    an IPPP clip: IVF, 16-bit recon and stat files byte-identical."""
    from _torch_parity import run_both_clis

    n = 3
    _write_yuv10(tmp_path / "in.yuv", clip10(n), packed)
    flags = ["-w", str(W), "-h", str(H), "-q", "40", "--bit-depth", "10",
             "--intra-period", "-1", "--pred-struct", "0", "--stat-report"]
    if packed:
        flags += ["--compressed-ten-bit", "1"]
    got = run_both_clis(tmp_path, flags)
    assert len(got["rec"]) == n * W * H * 3       # 2 bytes a sample


def test_state_takes_10bit_reference_planes():
    """The reference encoder's 10-bit slot-book planes (numpy uint16)
    become the port's int16 device planes with the same values; planes
    beyond 10 bits are refused."""
    from svt_av1_tpu_torch import state

    rng = np.random.default_rng(12)
    planes = [rng.integers(0, 1024, s).astype(np.uint16)
              for s in ((128, 192), (64, 96), (64, 96))]
    got = state.refs_from_numpy(*planes, device="cpu")
    assert all(t.dtype == torch.int16 for t in got)
    assert all(np.array_equal(t.numpy(), p) for t, p in zip(got, planes))
    book = state.store_from_reference(
        {4: {"dev": planes, "slot": 2, "pins": 3}}, device="cpu")
    assert book[4]["slot"] == 2 and book[4]["pins"] == 3
    assert torch.equal(book[4]["dev"][0], got[0])
    with pytest.raises(ValueError):
        state.refs_from_numpy(planes[0] + 1024, *planes[1:], device="cpu")
