"""The port's encoder CLI on low-delay B (--pred-struct 1) at 192x128,
against svt_av1_tpu.app.enc_app on the same raw YUV file: the IVF,
recon and stat files must be byte-identical, alone and with
--tiles-log2 1 and a QP file together (the flag set chip_smoke.py runs
on the card)."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import run_both_clis, write_yuv  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

W, H, N = 192, 128, 5
BASE = ["-w", str(W), "-h", str(H), "-q", "40", "--intra-period", "-1",
        "--pred-struct", "1", "--stat-report"]


@pytest.mark.parametrize("tiles_qp", [False, True],
                         ids=["ldb", "ldb-tiles-qp-file"])
def test_cli_ldb_files_byte_identical(tmp_path, tiles_qp):
    write_yuv(tmp_path / "in.yuv", W, H, N)
    flags = list(BASE)
    if tiles_qp:
        (tmp_path / "qp.txt").write_text("30\n-1\n45\n20\n")
        flags += ["--tiles-log2", "1", "--qp-file", str(tmp_path / "qp.txt")]
    got = run_both_clis(tmp_path, flags)
    assert len(got["rec"]) == N * W * H * 3 // 2
