"""Native entropy backend loader: builds/loads csrc/entropy.cpp via ctypes.

The library is built with ``g++`` at first use into
``build/svt_av1_tpu_torch/`` (utils/build.py), never into the package.

The CDF blob layout here and csrc/entropy.cpp TABLE_SIZES are the two
copies of one contract; test_entropy_backend pins them against each other
(and pins C++ tile output byte-identical to the Python TileWriter).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from svt_av1_tpu_torch.entropy.cdf_model import FrameContext
from svt_av1_tpu_torch.utils.build import build_shared

_CSRC = Path(__file__).parents[1] / "csrc" / "entropy.cpp"

# (FrameContext attribute, indexer) in blob order — must match C++ Tables
_TABLE_ORDER = [
    "kf_y_mode", "angle_delta", "uv_mode", "partition", "skip",
    "intra_ext_tx", "txb_skip", "dc_sign", "eob_extra", "coeff_br",
    "coeff_base", "coeff_base_eob",
    ("eob_pt", 16), ("eob_pt", 32), ("eob_pt", 64), ("eob_pt", 128),
    ("eob_pt", 256), ("eob_pt", 512), ("eob_pt", 1024),
    # inter (appended; must match csrc Tables)
    "newmv", "zeromv", "refmv", "drl", "intra_inter", "single_ref",
    "inter_ext_tx",
    "comp_inter", "comp_ref_type", "comp_ref", "comp_bwdref",
    "inter_compound_mode",
    "nmv_joints", "nmv_classes", "nmv_class0_fp", "nmv_fp", "nmv_sign",
    "nmv_class0_hp", "nmv_hp", "nmv_class0", "nmv_bits",
    "cfl_sign", "cfl_alpha", "delta_q",
]


def build_blob(fc: FrameContext) -> np.ndarray:
    parts = []
    for entry in _TABLE_ORDER:
        arr = fc.eob_pt[entry[1]] if isinstance(entry, tuple) \
            else getattr(fc, entry)
        parts.append(np.ascontiguousarray(arr, np.int32).ravel())
    return np.concatenate(parts)


@functools.lru_cache(maxsize=1)
def _lib():
    so = build_shared(_CSRC, "svtav1torch_entropy",
                      ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"])
    lib = ctypes.CDLL(str(so))
    lib.svt_tile_blob_size.restype = ctypes.c_long
    lib.svt_encode_tile.restype = ctypes.c_long
    lib.svt_encode_tile.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.svt_encode_tile_inter.restype = ctypes.c_long
    lib.svt_encode_tile_inter.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False


def encode_tile_cpp(fc: FrameContext, mi_rows: int, mi_cols: int, qindex: int,
                    modes: np.ndarray, levels_y: np.ndarray,
                    levels_u: np.ndarray, levels_v: np.ndarray,
                    reduced_tx_set: bool = True, cdef_idx=None,
                    cdef_bits: int = 2, angles=None, uv_modes=None,
                    cfl=None, sizes=None, levels16=None) -> bytes:
    lib = _lib()
    blob = build_blob(fc)
    assert blob.size == lib.svt_tile_blob_size(), \
        (blob.size, lib.svt_tile_blob_size())
    nbh, nbw = levels_y.shape[:2]
    m = np.ascontiguousarray(modes, np.uint8)
    ly = np.ascontiguousarray(levels_y, np.int32)
    lu = np.ascontiguousarray(levels_u, np.int32)
    lv = np.ascontiguousarray(levels_v, np.int32)
    cap = mi_rows * mi_cols * 256 + (1 << 16)  # ~16 bytes per pixel worst case
    out = np.empty(cap, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    ci = None if cdef_idx is None else np.ascontiguousarray(cdef_idx,
                                                            np.uint8)
    an = None if angles is None else np.ascontiguousarray(
        angles.astype(np.int8).view(np.uint8))
    uv = None if uv_modes is None else np.ascontiguousarray(uv_modes,
                                                            np.uint8)
    cf = None if cfl is None else np.ascontiguousarray(
        cfl.astype(np.int8).view(np.uint8))
    sz = None if sizes is None else np.ascontiguousarray(sizes, np.uint8)
    l16 = (None if levels16 is None else
           [np.ascontiguousarray(a, np.int32) for a in levels16])
    n = lib.svt_encode_tile(
        mi_rows, mi_cols, qindex, int(reduced_tx_set),
        p(blob, ctypes.c_int32), p(m, ctypes.c_uint8),
        p(ly, ctypes.c_int32), p(lu, ctypes.c_int32), p(lv, ctypes.c_int32),
        nbh, nbw, p(out, ctypes.c_uint8), cap,
        None if ci is None else p(ci, ctypes.c_uint8), cdef_bits,
        None if an is None else p(an, ctypes.c_uint8),
        None if uv is None else p(uv, ctypes.c_uint8),
        None if cf is None else p(cf, ctypes.c_uint8),
        None if sz is None else p(sz, ctypes.c_uint8),
        *((None,) * 3 if l16 is None else
          tuple(p(a, ctypes.c_int32) for a in l16)))
    if n < 0:
        raise RuntimeError("tile buffer overflow")
    return bytes(out[:n])


def encode_tile_inter_cpp(fc: FrameContext, mi_rows: int, mi_cols: int,
                          qindex: int, sizes: np.ndarray, mvs: np.ndarray,
                          levels: dict = None, reduced_tx_set: bool = True,
                          cdef_idx=None, cdef_bits: int = 2,
                          refs=None, sign_bias=None, mvs2=None,
                          comp_pair=(1, 7), txty=None, gm=None,
                          packs=None, qmap=None,
                          delta_q_res: int = 0) -> bytes:
    """levels: {8: (ly,lu,lv), ..., 64: (...)} per-size level grids; OR
    packs = (py, pu, pv) per-8x8-cell level tiles ([nb8h, nb8w, 8, 8]
    luma / [.., 4, 4] chroma int16 — the device step's native layout,
    saving the host the 12 per-size unpacks)."""
    lib = _lib()
    blob = build_blob(fc)
    assert blob.size == lib.svt_tile_blob_size(), \
        (blob.size, lib.svt_tile_blob_size())
    if qmap is not None:
        # the writer's running CurrentQIndex starts at base q and moves
        # in (1 << delta_q_res) steps: every target must sit on that
        # grid and in the decoder's Clip3 range or coded q diverges
        # from the quantization q (recon drift)
        step = 1 << delta_q_res
        qa = np.asarray(qmap, np.int32)
        assert ((qa - int(qindex)) % step == 0).all(), \
            "qmap targets not on the delta_q_res grid"
        assert (qa >= 1).all() and (qa <= 255).all(), \
            "qmap targets outside Clip3(1, 255)"
    nb8h, nb8w = sizes.shape
    sz = np.ascontiguousarray(sizes, np.uint8)
    mv = np.ascontiguousarray(mvs, np.int32)
    pk = None
    ptrs = None
    if packs is not None:
        pk = [np.ascontiguousarray(a, np.int16) for a in packs]
    else:
        if 64 not in levels:
            # callers without 64x64 leaves (sizes never reaches 64): zeros
            g64h, g64w = -(-nb8h // 8), -(-nb8w // 8)
            levels = dict(levels)
            levels[64] = (np.zeros((g64h, g64w, 64, 64), np.int32),
                          np.zeros((g64h, g64w, 32, 32), np.int32),
                          np.zeros((g64h, g64w, 32, 32), np.int32))
        lvl_arrs = [np.ascontiguousarray(levels[bs][pl], np.int32)
                    for bs in (8, 16, 32, 64) for pl in range(3)]
        ptrs = (ctypes.POINTER(ctypes.c_int32) * 12)(
            *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
              for a in lvl_arrs])
    cap = mi_rows * mi_cols * 256 + (1 << 16)
    out = np.empty(cap, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    ci = None if cdef_idx is None else np.ascontiguousarray(cdef_idx,
                                                            np.uint8)
    rf = None if refs is None else np.ascontiguousarray(refs, np.uint8)
    sb = None if sign_bias is None else np.ascontiguousarray(sign_bias,
                                                             np.uint8)
    m2 = None if mvs2 is None else np.ascontiguousarray(mvs2, np.int32)
    tt = None if txty is None else np.ascontiguousarray(txty, np.uint8)
    # global motion: {ref_type 1..7: (row8, col8)} -> [7] type + [7][2] mv
    gt = gv = None
    if gm:
        gt = np.zeros(7, np.uint8)
        gv = np.zeros((7, 2), np.int32)
        for rt, mv8 in gm.items():
            gt[rt - 1] = 1
            gv[rt - 1] = mv8
    n = lib.svt_encode_tile_inter(
        mi_rows, mi_cols, qindex, int(reduced_tx_set),
        p(blob, ctypes.c_int32), p(sz, ctypes.c_uint8),
        p(mv, ctypes.c_int32), ptrs,
        nb8h, nb8w, p(out, ctypes.c_uint8), cap,
        None if ci is None else p(ci, ctypes.c_uint8), cdef_bits,
        None if rf is None else p(rf, ctypes.c_uint8),
        None if sb is None else p(sb, ctypes.c_uint8),
        None if m2 is None else p(m2, ctypes.c_int32),
        comp_pair[0], comp_pair[1],
        None if tt is None else p(tt, ctypes.c_uint8),
        None if gt is None else p(gt, ctypes.c_uint8),
        None if gv is None else p(gv, ctypes.c_int32),
        None if pk is None else p(pk[0], ctypes.c_int16),
        None if pk is None else p(pk[1], ctypes.c_int16),
        None if pk is None else p(pk[2], ctypes.c_int16),
        None if qmap is None else p(
            np.ascontiguousarray(qmap, np.int32), ctypes.c_int32),
        delta_q_res)
    if n < 0:
        raise RuntimeError("tile buffer overflow")
    return bytes(out[:n])
