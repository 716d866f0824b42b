"""Grid-anchored tile gather — the MC/ME gather primitive of the port.

Port of svt_av1_tpu/ops/gather.py.  The reference's TPU kernel
``svt_av1_tpu/ops/gather.py::_gather_tiles_pallas`` becomes the CUDA
kernel ``csrc/gather_tiles.cu`` (route: nvcc to a plain-C shared
library for sm_90a, loaded with ctypes, built at first use into
``build/svt_av1_tpu_torch/``).

``gather_tiles`` launches the kernel for CUDA tensors and uses the plain
PyTorch version ``gather_tiles_ref`` only for CPU tensors; any other
device, dtype, layout or shape raises.  The kernel's bound on an H100 is
bytes: (plane bytes touched + 8 N index bytes + N th tw output bytes)
over 3.35 TB/s — memory-bound at every 720p call site.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from pathlib import Path

import torch

from svt_av1_tpu_torch.utils.build import build_shared

_SRC = Path(__file__).parents[1] / "csrc" / "gather_tiles.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPES = (torch.uint8, torch.int16, torch.int32)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA tile gather cannot "
                           "be built on this machine")
    return str(path)


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the gather library."""
    so = build_shared(_SRC, "svtav1torch_gather", [_nvcc()] + NVCC_FLAGS)
    lib = ctypes.CDLL(str(so))
    lib.svt_gather_tiles.restype = ctypes.c_int
    lib.svt_gather_tiles.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def clamp_starts(base_r, base_c, hp: int, wp: int, th: int, tw: int):
    """Tile starts as lax.dynamic_slice takes them: a negative start
    counts from the end (+ Hp / + Wp), then the start is clamped so the
    tile fits ([0, Hp-th] x [0, Wp-tw])."""
    r = base_r.long()
    c = base_c.long()
    r = torch.clamp(torch.where(r < 0, r + hp, r), 0, hp - th)
    c = torch.clamp(torch.where(c < 0, c + wp, c), 0, wp - tw)
    return r, c


def gather_tiles_ref(plane, base_r, base_c, th: int, tw: int):
    """Plain PyTorch tile gather: [N, th, tw] tiles at (base_r, base_c),
    starts mapped like lax.dynamic_slice (clamp_starts)."""
    hp, wp = plane.shape
    r, c = clamp_starts(base_r, base_c, hp, wp, th, tw)
    ar = torch.arange(th, device=plane.device)
    ac = torch.arange(tw, device=plane.device)
    return plane[(r[:, None] + ar[None, :])[:, :, None],
                 (c[:, None] + ac[None, :])[:, None, :]]


def _check(plane, base_r, base_c, th: int, tw: int) -> None:
    if plane.dim() != 2:
        raise ValueError(f"plane must be 2-D, got {tuple(plane.shape)}")
    if plane.dtype not in DTYPES:
        raise TypeError(f"gather_tiles takes {DTYPES}, got {plane.dtype}")
    if base_r.shape != base_c.shape or base_r.dim() != 1:
        raise ValueError("base_r / base_c must be equal-length 1-D tensors")
    if not (0 < th <= plane.shape[0] and 0 < tw <= plane.shape[1]):
        raise ValueError(f"tile {th}x{tw} outside plane "
                         f"{tuple(plane.shape)}")


def gather_tiles(plane, base_r, base_c, *, nbh: int, nbw: int, stride: int,
                 band_off: int, band_h: int, th: int, tw: int):
    """Gather N = nbh*nbw tiles of [th, tw] from a 2-D plane.

    Tiles are grid-anchored: tile k = i*nbw + j (row-major) starts at
    (base_r[k], base_c[k]) with the caller guaranteeing
    ``0 <= base_r[k] - (i*stride + band_off) <= band_h - th`` — grid row
    i reads only rows [i*stride + band_off, +band_h).  Returns
    [N, th, tw] in the plane's dtype, on the plane's device.

    CUDA tensors run csrc/gather_tiles.cu (counted in
    ``gather_tiles.launches``); CPU tensors run gather_tiles_ref.
    """
    hp = plane.shape[0]
    if band_off < 0 or (nbh - 1) * stride + band_off + band_h > hp:
        raise ValueError(f"band outside plane: Hp={hp} nbh={nbh} "
                         f"stride={stride} band_off={band_off} "
                         f"band_h={band_h}")
    _check(plane, base_r, base_c, th, tw)
    if base_r.shape[0] != nbh * nbw:
        raise ValueError(f"{base_r.shape[0]} starts for {nbh}x{nbw} tiles")
    if plane.device.type == "cpu":
        return gather_tiles_ref(plane, base_r, base_c, th, tw)
    return gather_tiles_cuda(plane, base_r, base_c, th, tw)


def gather_tiles_cuda(plane, base_r, base_c, th: int, tw: int):
    """Launch the CUDA kernel (no fallback): [N, th, tw] tiles."""
    _check(plane, base_r, base_c, th, tw)
    if plane.device.type != "cuda":
        raise RuntimeError(f"the CUDA tile gather needs a CUDA tensor, "
                           f"got one on {plane.device}")
    if not plane.is_contiguous():
        raise ValueError("plane must be contiguous")
    base_r = base_r.to(device=plane.device, dtype=torch.int32).contiguous()
    base_c = base_c.to(device=plane.device, dtype=torch.int32).contiguous()
    n = base_r.shape[0]
    out = torch.empty((n, th, tw), dtype=plane.dtype, device=plane.device)
    lib = kernel_library()
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.svt_gather_tiles(
            plane.data_ptr(), plane.shape[0], plane.shape[1],
            plane.element_size(), base_r.data_ptr(), base_c.data_ptr(),
            out.data_ptr(), n, th, tw, stream)
    if err != 0:
        raise RuntimeError(f"gather_tiles kernel launch failed: CUDA "
                           f"error {err}")
    gather_tiles.launches += 1
    return out


gather_tiles.launches = 0


def grid_tile_args(plane_pad, mv_r, mv_c, bs: int, pad: int, reach: int,
                   halo: int = 0, off: int = 0):
    """Starts and band geometry of a grid-anchored gather (see
    gather_blocks_grid): returns (base_r, base_c, gather_tiles kwargs)."""
    nbh, nbw = mv_r.shape
    th = bs + halo
    o = pad + 3 + off
    dev = plane_pad.device
    base_r = (torch.arange(nbh, dtype=torch.int32, device=dev)[:, None] * bs
              + o + mv_r.to(torch.int32)).reshape(-1)
    base_c = (torch.arange(nbw, dtype=torch.int32, device=dev)[None, :] * bs
              + o + mv_c.to(torch.int32)).reshape(-1)
    band_off = o - reach
    if band_off < 0:
        raise ValueError(f"reach {reach} exceeds the pad {pad}")
    return base_r, base_c, dict(nbh=nbh, nbw=nbw, stride=bs,
                                band_off=band_off, band_h=2 * reach + th,
                                th=th, tw=th)


def gather_blocks_grid(plane_pad, mv_r, mv_c, bs: int, pad: int,
                       reach: int, halo: int = 0, off: int = 0):
    """Grid-anchored gather from a pad_for_filter plane: block (i, j)
    reads a [bs+halo, bs+halo] tile starting at grid position
    (i*bs, j*bs) + (mv_r, mv_c) + off (pad_for_filter maps position p
    to index p + pad + 3).  |mv| <= reach must hold.
    Returns [nbh*nbw, bs+halo, bs+halo]."""
    base_r, base_c, kw = grid_tile_args(plane_pad, mv_r, mv_c, bs, pad,
                                        reach, halo, off)
    return gather_tiles(plane_pad, base_r, base_c, **kw)
