// Grid-anchored tile gather for the motion search and motion
// compensation of svt_av1_tpu_torch (ops/gather.py::gather_tiles).
//
// Replaces the TPU kernel svt_av1_tpu/ops/gather.py:151
// (_gather_tiles_pallas): for a stack of S planes [S, Hp, Wp] and N
// tiles per plane, out[s, k] = plane[s, r_sk : r_sk + th, c_sk : c_sk +
// tw], with the start mapped exactly as lax.dynamic_slice maps it (the
// reference's CPU path): a negative start is first taken from the end
// (+ Hp / + Wp), then clamped to [0, Hp - th] x [0, Wp - tw].  Planes of
// 1, 2 or 4-byte pixels.  S = 1 is the single-plane gather; S > 1 is the
// reference's kernel under jax.vmap (a batch grid axis): the S planes of
// a batched step (multi-stream encoding) gather in one launch, plane s
// on blockIdx.y = s.  Each plane, its starts and its output are reached
// through a 64-bit offset; inside a plane the indexing is 32-bit, so a
// plane or one plane's output of 2^31 bytes or more is refused.
//
// Bound on the H100: bytes.  The least time is the bytes the gather must
// move -- each plane byte it touches read once, the two int32 start
// arrays, and the N*th*tw output written once -- over the 3.35 TB/s of
// device memory (chip_smoke.py computes it per call site).  At the 720p
// call sites that is 1.5-20 MB, 0.5-6 us; nothing is computed but
// addresses.  So the design spends no instruction per element beyond an
// address add, reads each plane byte through L1 once per tile that needs
// it, and writes the output with coalesced stores as wide as it allows:
//
//   * 32-bit index arithmetic; each tile's start is loaded and clamped
//     once; a thread walks the flat tile with a fixed (row, column)
//     stride worked out once per thread, so no element pays a division.
//   * A tile is contiguous in `out`, so a warp writes 32 consecutive
//     units per store.  A unit is one pixel, or, for 1- and 2-byte
//     planes whose tile rows are whole 32-bit words, a word assembled
//     from the two aligned plane words it straddles (one funnel shift).
//   * gather_tiles_direct (the main path's design): one warp per tile,
//     loads straight from device memory through L1/L2 (the neighbouring
//     tiles' overlapping reads hit there).  It stages nothing: copying
//     a run of 16 tiles' band window into shared memory with cp.async,
//     as the TPU kernel's band DMA did, measured 1.2-7.9x slower at
//     every 720p call site (PERF.md).
//   * gather_tiles_v1: the first port's one-thread-per-element kernel
//     with a 64-bit division per element, kept as a timing yardstick.
//     ops/gather.py runs it only when chip_smoke.py times it.
//
// The library is a CPython extension module (no PyTorch headers, so nvcc
// builds it in seconds) with one function, gather_tiles, that launches a
// design on the caller's stream, allocates nothing and raises if
// cudaGetLastError() after the launch is not cudaSuccess.

#define PY_SSIZE_T_CLEAN
#include <Python.h>  // first, as the CPython API asks

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // warps (tiles) per CTA

__device__ __forceinline__ int map_start(int s, int size, int t) {
  s = s < 0 ? s + size : s;
  return min(max(s, 0), size - t);
}

// Unit u of tile row y, for one pixel per unit.
template <typename U>
struct PixelSrc {
  const U* p;
  int pitch;  // in units
  __device__ __forceinline__ U operator()(int y, int u) const {
    return p[y * pitch + u];
  }
};

// Unit u of tile row y, for four bytes per unit that start `shift` bits
// into an aligned word: the two words they straddle, funnel-shifted.
struct WordSrc {
  const uint32_t* p;
  int pitch;  // in words
  unsigned shift;
  __device__ __forceinline__ uint32_t operator()(int y, int u) const {
    const uint32_t* q = p + y * pitch + u;
    const uint32_t lo = q[0];
    return shift ? __funnelshift_r(lo, q[1], shift) : lo;
  }
};

// One warp copies a [th, tu]-unit tile to the contiguous dst: lane l
// takes flat units l, l + 32, ..., stepping its (row, column) by
// (32 / tu, 32 % tu) with one carry instead of dividing.
template <typename U, typename Src>
__device__ __forceinline__ void copy_tile(const Src& src, U* __restrict__ dst,
                                          int th, int tu, int lane) {
  const int count = th * tu;
  const int dy = 32 / tu, dx = 32 - dy * tu;
  int y = lane / tu, x = lane - y * tu;
#pragma unroll 4
  for (int e = lane; e < count; e += 32) {
    dst[e] = src(y, x);
    x += dx;
    y += dy;
    if (x >= tu) {
      x -= tu;
      ++y;
    }
  }
}

// One warp per tile.  kWords: U is uint32_t and the units are 4-byte
// words of a plane of esize-byte pixels (esize < 4, tw * esize % 4 == 0,
// row pitch % 4 == 0).
template <typename U, bool kWords>
__global__ void __launch_bounds__(kWarps * 32)
    gather_tiles_direct(const void* __restrict__ planes, int hp, int wp,
                        int esize, const int32_t* __restrict__ base_r,
                        const int32_t* __restrict__ base_c,
                        U* __restrict__ out, int n, int th, int tw) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n) return;
  // plane s of the stack: 64-bit offsets to its pixels, starts and
  // output; 32-bit indexing inside it
  const size_t s = blockIdx.y;
  const char* plane =
      static_cast<const char*>(planes) + s * hp * wp * (size_t)esize;
  const int r0 = map_start(base_r[s * n + k], hp, th);
  const int c0 = map_start(base_c[s * n + k], wp, tw);
  const int lane = threadIdx.x & 31;
  if constexpr (kWords) {
    const int pitch_b = wp * esize;
    const int b = r0 * pitch_b + c0 * esize;
    const int tu = tw * esize >> 2;
    const WordSrc src{reinterpret_cast<const uint32_t*>(plane) + (b >> 2),
                      pitch_b >> 2, static_cast<unsigned>(b & 3) * 8u};
    copy_tile(src, out + s * n * th * tu + k * th * tu, th, tu, lane);
  } else {
    const PixelSrc<U> src{reinterpret_cast<const U*>(plane) + r0 * wp + c0,
                          wp};
    copy_tile(src, out + s * n * th * tw + k * th * tw, th, tw, lane);
  }
}

// The first port's kernel: one thread per output element, a 64-bit
// division per element, both clamps per element.
template <typename T>
__global__ void gather_tiles_v1(const T* __restrict__ plane, int hp, int wp,
                                const int32_t* __restrict__ base_r,
                                const int32_t* __restrict__ base_c,
                                T* __restrict__ out, long long total, int th,
                                int tw) {
  const int tile = th * tw;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const int k = (int)(e / tile);
    const int rem = (int)(e - (long long)k * tile);
    const int y = rem / tw;
    const int x = rem - y * tw;
    int r0 = base_r[k];
    int c0 = base_c[k];
    r0 = min(max(r0 < 0 ? r0 + hp : r0, 0), hp - th);
    c0 = min(max(c0 < 0 ? c0 + wp : c0, 0), wp - tw);
    out[e] = plane[(long long)(r0 + y) * wp + (c0 + x)];
  }
}

template <typename T>
void launch_v1(const void* plane, int hp, int wp, const int32_t* base_r,
               const int32_t* base_c, void* out, int n, int th, int tw,
               cudaStream_t s) {
  const long long total = (long long)n * th * tw;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  gather_tiles_v1<T><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const T*>(plane), hp, wp, base_r, base_c,
      static_cast<T*>(out), total, th, tw);
}

template <typename U, bool kWords>
void launch_direct(const void* plane, int ns, int hp, int wp, int esize,
                   const int32_t* base_r, const int32_t* base_c, void* out,
                   int n, int th, int tw, cudaStream_t s) {
  const dim3 blocks((n + kWarps - 1) / kWarps, ns);
  gather_tiles_direct<U, kWords><<<blocks, kWarps * 32, 0, s>>>(
      plane, hp, wp, esize, base_r, base_c, static_cast<U*>(out), n, th, tw);
}

// design: 0 = direct, 1 = v1.  ns planes of [hp, wp] back to back, n
// starts and n tiles per plane.  The caller guarantees int32 starts and
// contiguous planes and output; a plane or one plane's output of 2^31
// bytes or more is refused (32-bit indexing inside a plane), and so are
// more planes than a grid's y dimension holds.
cudaError_t gather(int design, const void* plane, int ns, int hp, int wp,
                   int elem_bytes, const void* base_r, const void* base_c,
                   void* out, int n, int th, int tw, cudaStream_t s) {
  if (n == 0 || ns == 0) return cudaSuccess;
  if (n < 0 || ns < 0 || ns > 65535 || th <= 0 || tw <= 0 || th > hp ||
      tw > wp ||
      (long long)hp * wp * elem_bytes > INT_MAX ||
      (long long)n * th * tw * elem_bytes > INT_MAX)
    return cudaErrorInvalidValue;
  const int32_t* br = static_cast<const int32_t*>(base_r);
  const int32_t* bc = static_cast<const int32_t*>(base_c);
  if (design == 1) {
    // the yardstick gathers one plane per launch
    const size_t plane_b = (size_t)hp * wp * elem_bytes;
    const size_t out_b = (size_t)n * th * tw * elem_bytes;
    for (int k = 0; k < ns; ++k) {
      const void* p = static_cast<const char*>(plane) + k * plane_b;
      void* o = static_cast<char*>(out) + k * out_b;
      const int32_t* r = br + (size_t)k * n;
      const int32_t* c = bc + (size_t)k * n;
      switch (elem_bytes) {
        case 1: launch_v1<uint8_t>(p, hp, wp, r, c, o, n, th, tw, s); break;
        case 2: launch_v1<uint16_t>(p, hp, wp, r, c, o, n, th, tw, s); break;
        case 4: launch_v1<uint32_t>(p, hp, wp, r, c, o, n, th, tw, s); break;
        default: return cudaErrorInvalidValue;
      }
    }
    return cudaGetLastError();
  }
  if (design != 0) return cudaErrorInvalidValue;
  // words when a tile row is whole 32-bit words of a sub-word plane
  // whose rows start on word boundaries; else one pixel per unit
  const bool rows4 = (wp * elem_bytes) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(plane) % 4 == 0;
  if (elem_bytes < 4 && rows4 && (tw * elem_bytes) % 4 == 0) {
    launch_direct<uint32_t, true>(plane, ns, hp, wp, elem_bytes, br, bc, out,
                                  n, th, tw, s);
  } else {
    switch (elem_bytes) {
      case 1:
        launch_direct<uint8_t, false>(plane, ns, hp, wp, 1, br, bc, out,
                                      n, th, tw, s);
        break;
      case 2:
        launch_direct<uint16_t, false>(plane, ns, hp, wp, 2, br, bc, out,
                                       n, th, tw, s);
        break;
      case 4:
        launch_direct<uint32_t, false>(plane, ns, hp, wp, 4, br, bc, out,
                                       n, th, tw, s);
        break;
      default:
        return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

// gather_tiles(design, plane, ns, hp, wp, elem_bytes, base_r, base_c,
// out, n, th, tw, stream): pointers and the stream handle as Python ints
// (ns planes, n tiles per plane).  A
// METH_FASTCALL binding, so the call itself costs about 0.3 us of host
// time on the H100's host (tools/gather_host_costs.py), against a kernel
// of 2-10 us.
PyObject* py_gather_tiles(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  constexpr int kArgs = 13;
  if (nargs != kArgs) {
    PyErr_SetString(PyExc_TypeError, "gather_tiles takes 13 arguments");
    return nullptr;
  }
  long v[kArgs];
  for (int i = 0; i < kArgs; ++i) {
    v[i] = PyLong_AsLong(args[i]);
    if (v[i] == -1 && PyErr_Occurred()) return nullptr;
  }
  auto ptr = [](long x) { return reinterpret_cast<void*>(x); };
  const cudaError_t err =
      gather((int)v[0], ptr(v[1]), (int)v[2], (int)v[3], (int)v[4],
             (int)v[5], ptr(v[6]), ptr(v[7]), ptr(v[8]), (int)v[9],
             (int)v[10], (int)v[11], static_cast<cudaStream_t>(ptr(v[12])));
  if (err != cudaSuccess) {
    PyErr_Format(PyExc_RuntimeError,
                 "gather_tiles kernel launch failed: CUDA error %d (%s)",
                 (int)err, cudaGetErrorString(err));
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"gather_tiles", reinterpret_cast<PyCFunction>(
                         reinterpret_cast<void (*)(void)>(py_gather_tiles)),
     METH_FASTCALL, "Launch one tile gather on the given stream."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "svtav1torch_gather", nullptr,
                       -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_svtav1torch_gather(void) {
  return PyModule_Create(&kModule);
}
