"""The port's encoder CLI on hierarchical B (--pred-struct 2,
--hierarchical-levels 2) at 192x128, against svt_av1_tpu.app.enc_app
on the same raw YUV file: no-show TUs bundled into the next shown IVF
frame and the recon written in display order, so the IVF, recon and
stat files must be byte-identical, with a QP file consumed in decode
order."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import run_both_clis, write_yuv  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

W, H, N = 192, 128, 6


def test_cli_hierb_files_byte_identical(tmp_path):
    write_yuv(tmp_path / "in.yuv", W, H, N)
    (tmp_path / "qp.txt").write_text("30\n44\n36\n20\n50\n40\n")
    got = run_both_clis(tmp_path, [
        "-w", str(W), "-h", str(H), "-q", "40", "--intra-period", "-1",
        "--pred-struct", "2", "--hierarchical-levels", "2",
        "--qp-file", str(tmp_path / "qp.txt"), "--stat-report"])
    assert len(got["rec"]) == N * W * H * 3 // 2
    # one IVF frame per shown picture
    assert int.from_bytes(got["ivf"][24:28], "little") == N
