// Batched row gather for Hopper (sm_90a): the MoE dispatch / combine copy.
//
// Replaces src/repro/kernels/gather_rows.py::_gather_kernel (vmapped over a
// leading group axis by repro/kernels/ops.py::_rows). It computes
//   out[g, i, :] = src[g, idx[g, i], :]
// for src (G, N, d), idx (G, M) int32 and out (G, M, d), in float32 or
// bfloat16. idx < 0 gives a zero row and reads nothing; idx >= N reads row
// N - 1, as the plain version's clipped take_along_axis does, so the kernel
// never reads out of bounds and never asks the host to check.
//
// Bound: it is a copy, so bytes bound it: each output row is written once
// and each row it names is read, at the card's memory rate. No arithmetic.
//
// Design. The TPU kernel keeps idx in scalar-prefetch SMEM and issues one
// DMA per row from HBM into a VMEM block of 8 rows. Here one warp owns one
// output row: lane 0's load of the index is broadcast to the warp, and the
// 32 lanes copy the row with 16-byte vector loads and stores, neighbouring
// lanes on neighbouring addresses, when every row start is 16-byte aligned
// (the row's bytes, the strides and both base pointers are multiples of
// 16); otherwise element by element (d = 80 in f32 is aligned, d = 1 is
// not). The copy moves bits, so NaN payloads and signed zeros pass as they
// are. Blocks of 8 warps cover 8 consecutive rows of one group; the group
// is the grid's y axis, so G is handled by the grid itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // output rows per block
constexpr int LANES = 32;

template <typename V>
__global__ void gather_rows_kernel(
    const char* __restrict__ src, const int32_t* __restrict__ idx,
    char* __restrict__ out, int N, int M, int units,
    long long src_sg, long long src_sn, long long idx_sg, long long idx_sm,
    long long out_sg, long long out_sm) {
  const int warp = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const long long i = (long long)blockIdx.x * WARPS + warp;
  if (i >= M) return;
  const long long g = blockIdx.y;
  int r = 0;
  if (lane == 0) r = idx[g * idx_sg + i * idx_sm];
  r = __shfl_sync(0xffffffffu, r, 0);
  V* o = reinterpret_cast<V*>(out + g * out_sg + i * out_sm);
  if (r < 0) {
    const V zero{};
    for (int j = lane; j < units; j += LANES) o[j] = zero;
    return;
  }
  r = min(r, N - 1);
  const V* s = reinterpret_cast<const V*>(src + g * src_sg + (long long)r * src_sn);
  for (int j = lane; j < units; j += LANES) o[j] = s[j];
}

template <typename V>
cudaError_t launch(const void* src, const void* idx, void* out, int G, int N, int M,
                   long long row_bytes, long long src_sg, long long src_sn,
                   long long idx_sg, long long idx_sm, long long out_sg,
                   long long out_sm, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + WARPS - 1) / WARPS), (unsigned)G);
  gather_rows_kernel<V><<<grid, WARPS * LANES, 0, stream>>>(
      static_cast<const char*>(src), static_cast<const int32_t*>(idx),
      static_cast<char*>(out), N, M, (int)(row_bytes / sizeof(V)),
      src_sg, src_sn, idx_sg, idx_sm, out_sg, out_sm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. src (G, N, d) and out (G, M, d)
// have a unit stride on d; idx (G, M) is int32. Strides are in elements;
// elem_size is 4 (float32) or 2 (bfloat16). The kernel runs on `stream`
// and is not synchronised; the return value is cudaGetLastError() after
// the launch (0 on success). M = 0 launches nothing.
extern "C" int gather_rows_fwd(
    const void* src, const void* idx, void* out, int elem_size,
    int G, int N, int M, int d,
    long long src_sg, long long src_sn, long long idx_sg, long long idx_sm,
    long long out_sg, long long out_sm, void* stream) {
  if ((elem_size != 2 && elem_size != 4) || G < 1 || G > 65535 || N < 1 || M < 0 || d < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const long long es = elem_size;
  const long long row_bytes = d * es;
  const long long sg = src_sg * es, sn = src_sn * es, og = out_sg * es, om = out_sm * es;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = row_bytes % 16 == 0 && sg % 16 == 0 && sn % 16 == 0 && og % 16 == 0 &&
                   om % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return (int)launch<uint4>(src, idx, out, G, N, M, row_bytes, sg, sn, idx_sg, idx_sm,
                              og, om, s);
  if (elem_size == 4)
    return (int)launch<uint32_t>(src, idx, out, G, N, M, row_bytes, sg, sn, idx_sg,
                                 idx_sm, og, om, s);
  return (int)launch<uint16_t>(src, idx, out, G, N, M, row_bytes, sg, sn, idx_sg, idx_sm,
                               og, om, s);
}
