// Grid-anchored tile gather for the motion search and motion
// compensation of svt_av1_tpu_torch (ops/gather.py::gather_tiles).
//
// Replaces the TPU kernel svt_av1_tpu/ops/gather.py::_gather_tiles_pallas:
// for a 2-D plane [Hp, Wp] and N tiles, out[k] = plane[r_k : r_k + th,
// c_k : c_k + tw], with the start mapped exactly as lax.dynamic_slice
// maps it (the reference's CPU path): a negative start is first taken
// from the end (+ Hp / + Wp), then clamped to [0, Hp - th] x [0, Wp - tw].
//
// Bound on the H100: pure data movement.  The least time is the bytes
// the gather must move -- each plane byte it touches read once, the two
// int32 start arrays, and the N*th*tw output written once -- over the
// 3.35 TB/s of device memory.  At the 720p call sites this is a few MB,
// so it is memory-bound (no arithmetic beyond index math).
//
// Design: one thread per output element, neighbouring threads on
// neighbouring output elements of a tile (coalesced stores; the loads of
// a tile row are contiguous too).  The TPU kernel staged each grid row's
// band in VMEM because its vector loads must be aligned; on Hopper the
// L1/L2 caches serve the overlapping tile reads, so this first version
// stages nothing.  The kernel copies by element width (1, 2 or 4 bytes),
// so one body serves every pixel dtype; it allocates nothing and runs on
// the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

template <typename T>
__global__ void gather_tiles_kernel(const T* __restrict__ plane, int hp,
                                    int wp, const int32_t* __restrict__ base_r,
                                    const int32_t* __restrict__ base_c,
                                    T* __restrict__ out, long long total,
                                    int th, int tw) {
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
static void launch(const void* plane, int hp, int wp, const void* base_r,
                   const void* base_c, void* out, long long total, int th,
                   int tw, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  gather_tiles_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(plane), hp, wp,
      static_cast<const int32_t*>(base_r), static_cast<const int32_t*>(base_c),
      static_cast<T*>(out), total, th, tw);
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int svt_gather_tiles(const void* plane, int hp, int wp,
                                int elem_bytes, const void* base_r,
                                const void* base_c, void* out, int n, int th,
                                int tw, void* stream) {
  const long long total = (long long)n * th * tw;
  if (total == 0) return 0;
  if (th > hp || tw > wp || th <= 0 || tw <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      launch<uint8_t>(plane, hp, wp, base_r, base_c, out, total, th, tw, s);
      break;
    case 2:
      launch<uint16_t>(plane, hp, wp, base_r, base_c, out, total, th, tw, s);
      break;
    case 4:
      launch<uint32_t>(plane, hp, wp, base_r, base_c, out, total, th, tw, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
