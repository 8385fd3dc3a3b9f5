// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py:26, _ssd_kernel (launched by ssd_pallas).
// It computes what repro_torch/kernels/ref.py::ssd_ref computes with
// return_state, from a zero state: for x (B, S, H, P), dt (B, S, H) float32
// after softplus, A (H,) float32 (negative), and B, C (B, S, N) of one
// group, chunk by chunk of length T along S, with cum = cumsum(dt * A)
// inside the chunk and X = x * dt taken in float32,
//   y     = ((C B^T) o L) X + (C state^T) o exp(cum),
//           L[i, j] = exp(cum_i - cum_j) for j <= i, else 0,
//   state = exp(cum_last) state + X^T (B o exp(cum_last - cum)).
// y has x's dtype; the final state (B, H, P, N) is written in float32.
//
// Bound: at a prefill of mamba2-1.3b (S 2048, H 64, P 64, N 128, T 256) the
// work is the chunk's products, about 6.3 GFLOP with the causal half
// skipped and C B^T counted once per chunk, against 37 MB moved; at the
// card's bf16 rate that is 6.3 us and at its memory rate 11 us, so bytes
// bound it. This design does every product as a float32 FMA on the CUDA
// cores, so operations on the CUDA cores, not bytes, set its time.
//
// Design. The TPU kernel walks the chunks as a sequential grid axis with
// the (P, N) state in VMEM and builds L as a T x T matrix. On the GPU the
// blocks run in no order, so the chunk loop is inside the block and the
// state stays in shared memory. Two passes, launched one after the other
// on the stream:
// 1. ssd_scores: C B^T of every chunk, once, into a float32 scratch
//    (B, S/T, T, T), 64 x 64 tiles on or below the diagonal only. B and C
//    are shared by every head (one group), so the heads do not each redo
//    this product, which is most of the chunk's operations.
// 2. ssd_scan: one block per (batch, head, 16 channels). The rows of the
//    state are independent across the head's channels p (y[:, p] reads
//    only X[:, p] and state[p, :]), so splitting P needs no reduction
//    across blocks: 256 blocks at B 1, H 64, P 64, two on each SM. Per
//    chunk and 64-row tile I: C_I in shared memory; for every column tile
//    J <= I the scores tile read from the scratch, scaled by
//    exp(cum_i - cum_j) from cum (in shared memory), y_I += P X_J in
//    registers; then the carried state's part, and the store. C_I and the
//    scores tile are kept transposed, so that a thread's four rows come in
//    one 16-byte load: the products read shared memory about once for
//    every two FMAs, which sets their pace on the CUDA cores. L is never
//    built (at T 256 it alone would be 256 KB, more than a block's 227
//    KB), and the exponential is taken only where j <= i: above the
//    diagonal it would overflow, and inf * 0 is NaN. A decay that
//    underflows gives 0. While the last row tile walks every J, B_J and
//    X_J give the chunk's state update, summed in registers and applied
//    after the last use of the old state.
// Any chunk length up to 256 is taken (S must be a multiple of it: the
// caller pads with dt = 0, which leaves the state as it is); rows and
// channels past the edge are zeros. Tensor cores, TMA and wgmma are not
// used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block: 16 x 16
constexpr int BT = 64;      // chunk rows per tile
constexpr int PT = 16;      // head channels per scan block: one per tx
constexpr int NMAX = 128;   // largest state size N
constexpr int TMAX = 256;   // longest chunk
constexpr int XS = PT + 4;  // row stride of the X tile: rows 16-byte aligned
constexpr int CS = BT + 4;  // column stride of the transposed C and score tiles
constexpr int NG = NT / NMAX;  // 2 thread groups over the state's rows
constexpr int DPT = PT / NG;   // 8 state-update sums per thread
static_assert(NT == 256 && PT == 16 && DPT == 8,
              "ssd_scan maps 16 x 16 threads onto 64 rows x 16 channels, two float4 of delta");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows first .. first + BT - 1 of a (rows, N) matrix with row stride ss into
// shared memory as float32, row r at dst + r * ld (or, transposed, column r
// at dst + r with rows ld apart); rows at or past T are zeros. Warp w loads
// rows w, w + 8, ..., its lanes neighbouring elements; the loops have fixed
// trip counts, so every load of a thread is in flight at once.
template <typename E, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(float* dst, int ld, const E* src, long long ss,
                                          int first, int T, int N) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int rr = 0; rr < BT / (NT / 32); ++rr) {
    const int r = warp + (NT / 32) * rr;
    const bool in = first + r < T;
    const E* row = src + (long long)(first + r) * ss;
    float v[NMAX / 32];
#pragma unroll
    for (int k = 0; k < NMAX / 32; ++k) {
      const int n = lane + 32 * k;
      v[k] = (in && n < N) ? to_f32(row[n]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < NMAX / 32; ++k) {
      const int n = lane + 32 * k;
      if (n < N) (TRANSPOSE ? dst[n * ld + r] : dst[r * ld + n]) = v[k];
    }
  }
}

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  void* y;
  float* state;   // (B, H, P, N) contiguous
  float* scores;  // (B, S / T, T, T) scratch: C B^T of each chunk
  int S, H, P, N, T;
  long long x_sb, x_ss, x_sh;  // element strides; unit stride on P
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;  // unit stride on N
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;  // unit stride on P
};

// Row stride of the N-wide tiles: odd, so that threads reading one column
// of different rows hit different banks.
__host__ __device__ __forceinline__ int row_stride(int N) { return N | 1; }

// Pass 1: one block per (64 x 64 tile on or below the diagonal, chunk,
// batch) writes that tile of C B^T, rows ty + 16u and columns tx + 16v of
// each thread.
template <typename E>
__global__ void __launch_bounds__(NT) ssd_scores(Params p) {
  const int N = p.N, T = p.T, NS = row_stride(N);
  const int nt = (T + BT - 1) / BT, npairs = nt * (nt + 1) / 2;
  const int c = blockIdx.x / npairs, b = blockIdx.y;
  int it = 0, k = blockIdx.x % npairs;
  while (k > it) k -= ++it;  // the k-th tile pair (it, jt) with jt <= it
  const int i0 = it * BT, j0 = k * BT, c0 = c * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ float smem[];
  float* Cs = smem;          // BT x NS
  float* Bs = Cs + BT * NS;  // BT x NS
  const E* bg = static_cast<const E*>(p.b) + b * p.b_sb;
  const E* cg = static_cast<const E*>(p.c) + b * p.c_sb;
  load_rows<E, false>(Cs, NS, cg + (long long)c0 * p.c_ss, p.c_ss, i0, T, N);
  load_rows<E, false>(Bs, NS, bg + (long long)c0 * p.b_ss, p.b_ss, j0, T, N);
  __syncthreads();

  float sc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) sc[u][v] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cv[u] = Cs[(ty + 16 * u) * NS + n];
#pragma unroll
    for (int v = 0; v < 4; ++v) bv[v] = Bs[(tx + 16 * v) * NS + n];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) sc[u][v] = fmaf(cv[u], bv[v], sc[u][v]);
  }
  float* out = p.scores + ((long long)b * (p.S / T) + c) * T * T;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (i < T && j < T) out[(long long)i * T + j] = sc[u][v];
    }
  }
}

// Pass 2: the scan. Thread (tx, ty) owns rows 4 ty .. 4 ty + 3 of the row
// tile and channel tx of y, and channels 8 sg .. 8 sg + 7 of column sn of
// the state update. C and the scores tile sit transposed in shared memory
// (column-major, CS apart), so that one 16-byte load gives a thread its
// four rows. Two blocks share an SM (about 100 KB of shared memory each);
// the launch bounds hold the registers to 128 a thread so that both fit.
template <typename E>
__global__ void __launch_bounds__(NT, 2) ssd_scan(Params p) {
  const int N = p.N, T = p.T, NS = row_stride(N);
  const int b = blockIdx.z, h = blockIdx.y, p0 = blockIdx.x * PT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, r0 = 4 * ty;
  const int pw = min(PT, p.P - p0);            // channels of this block
  const int sn = tid % NMAX, sg = tid / NMAX;  // this thread's state column, row group

  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;             // N x CS: C of the row tile, transposed
  float* Bs = Ct + N * CS;      // BT x NS: B of the column tile
  float* St = Bs + BT * NS;     // PT x NS: the carried state
  float* Xs = St + PT * NS;     // BT x XS: x * dt of the column tile
  float* Pt = Xs + BT * XS;     // BT x CS: masked, decayed scores, transposed
  float* cum = Pt + BT * CS;    // TMAX: cumsum of dt * A in the chunk
  float* wend = cum + TMAX;     // TMAX: exp(cum_last - cum_j)
  float* dts = wend + TMAX;     // TMAX: dt of the chunk

  const E* xg = static_cast<const E*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const float* dg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const E* bg = static_cast<const E*>(p.b) + b * p.b_sb;
  const E* cg = static_cast<const E*>(p.c) + b * p.c_sb;
  E* yg = static_cast<E*>(p.y) + b * p.y_sb + h * p.y_sh + p0;
  const float a = p.A[h];

  for (int i = tid; i < PT * NS; i += NT) St[i] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += T) {
    __syncthreads();  // the last chunk is done with cum, wend, dts
    for (int i = tid; i < T; i += NT) {
      const float d = dg[(long long)(c0 + i) * p.dt_ss];
      dts[i] = d;
      cum[i] = d * a;
    }
    __syncthreads();
    if (tid < 32) {  // inclusive scan of cum by one warp: 32 runs, then their offsets
      const int per = (T + 31) / 32;
      const int lo = tid * per, hi = min(lo + per, T);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += cum[i];
        cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float offset = incl - run;
      for (int i = lo; i < hi; ++i) cum[i] += offset;
    }
    __syncthreads();
    const float cum_last = cum[T - 1];
    for (int i = tid; i < T; i += NT) wend[i] = expf(cum_last - cum[i]);
    const float* scores = p.scores + ((long long)b * (p.S / T) + c0 / T) * T * T;

    float delta[DPT];
#pragma unroll
    for (int k = 0; k < DPT; ++k) delta[k] = 0.f;

    const int nt = (T + BT - 1) / BT;
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * BT;
      __syncthreads();  // the last row tile is done with Ct; wend is in
      load_rows<E, true>(Ct, CS, cg + (long long)c0 * p.c_ss, p.c_ss, i0, T, N);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * BT;
        __syncthreads();  // Bs, Xs and Pt of the last column tile are consumed
        if (it == nt - 1)  // B only for the state update
          load_rows<E, false>(Bs, NS, bg + (long long)c0 * p.b_ss, p.b_ss, j0, T, N);
#pragma unroll
        for (int i = tid; i < BT * PT; i += NT) {
          const int r = i / PT, q = i % PT;
          const int s = j0 + r;
          Xs[r * XS + q] = (s < T && q < pw)
              ? to_f32(xg[(long long)(c0 + s) * p.x_ss + q]) * dts[s] : 0.f;
        }
        // The scores tile, decayed and masked (exp only where j <= i), for
        // rows r0 .. r0 + 3 and columns tx + 16 v.
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = j0 + tx + 16 * v;
          float pv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + r0 + u;
            pv[u] = (j <= i && i < T) ? scores[(long long)i * T + j] * expf(cum[i] - cum[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(Pt + (tx + 16 * v) * CS + r0) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
        }
        __syncthreads();

        // y_I += P X_J.
#pragma unroll 8
        for (int j = 0; j < BT; ++j) {
          const float4 pv = *reinterpret_cast<const float4*>(Pt + j * CS + r0);
          const float xv = Xs[j * XS + tx];
          acc[0] = fmaf(pv.x, xv, acc[0]);
          acc[1] = fmaf(pv.y, xv, acc[1]);
          acc[2] = fmaf(pv.z, xv, acc[2]);
          acc[3] = fmaf(pv.w, xv, acc[3]);
        }

        // The last row tile walks every column tile of the chunk: the
        // state update X^T (B o exp(cum_last - cum)).
        if (it == nt - 1 && sn < N) {
          const int jn = min(BT, T - j0);
          for (int j = 0; j < jn; ++j) {
            const float bw = Bs[j * NS + sn] * wend[j0 + j];
            const float4 x0 = *reinterpret_cast<const float4*>(Xs + j * XS + DPT * sg);
            const float4 x1 = *reinterpret_cast<const float4*>(Xs + j * XS + DPT * sg + 4);
            delta[0] = fmaf(x0.x, bw, delta[0]);
            delta[1] = fmaf(x0.y, bw, delta[1]);
            delta[2] = fmaf(x0.z, bw, delta[2]);
            delta[3] = fmaf(x0.w, bw, delta[3]);
            delta[4] = fmaf(x1.x, bw, delta[4]);
            delta[5] = fmaf(x1.y, bw, delta[5]);
            delta[6] = fmaf(x1.z, bw, delta[6]);
            delta[7] = fmaf(x1.w, bw, delta[7]);
          }
        }
      }

      // The carried state's part, exp(cum_i) C_i state^T, and the store.
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(Ct + n * CS + r0);
        const float sv = St[tx * NS + n];
        sum[0] = fmaf(cv.x, sv, sum[0]);
        sum[1] = fmaf(cv.y, sv, sum[1]);
        sum[2] = fmaf(cv.z, sv, sum[2]);
        sum[3] = fmaf(cv.w, sv, sum[3]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + r0 + u;
        if (i < T && tx < pw)
          store(yg + (long long)(c0 + i) * p.y_ss + tx, fmaf(expf(cum[i]), sum[u], acc[u]));
      }
    }

    __syncthreads();  // every read of the old state is done
    if (sn < N) {
      const float dec = expf(cum_last);
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        float* s = St + (DPT * sg + k) * NS + sn;
        *s = fmaf(*s, dec, delta[k]);
      }
    }
  }

  __syncthreads();
  float* out = p.state + ((long long)b * p.H + h) * p.P * N + (long long)p0 * N;
  for (int i = tid; i < pw * N; i += NT) out[i] = St[(i / N) * NS + i % N];
}

size_t scan_smem_bytes(int N) {
  const int NS = row_stride(N);
  return sizeof(float) *
         ((size_t)N * CS + (size_t)(BT + PT) * NS + (size_t)BT * XS + (size_t)BT * CS + 3 * TMAX);
}

template <typename E>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem1 = sizeof(float) * 2 * BT * row_stride(p.N);
  const size_t smem2 = scan_smem_bytes(p.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scores<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_scan<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  const int nt = (p.T + BT - 1) / BT;
  ssd_scores<E><<<dim3((unsigned)(p.S / p.T * (nt * (nt + 1) / 2)), B), NT, smem1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan<E><<<dim3((p.P + PT - 1) / PT, p.H, B), NT, smem2, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. x and y are (B, S, H, P) with a
// unit stride on P, dt is (B, S, H) float32, A (H,) float32 contiguous, B
// and C (B, S, N) with a unit stride on N, state (B, H, P, N) float32
// contiguous, scores a float32 scratch of B * S * chunk elements; other
// strides are in elements. dtype (of x, B, C and y):
// 0 = float32, 1 = bfloat16. 1 <= N <= 128, 1 <= chunk <= 256, S a
// multiple of chunk. The kernel runs on `stream` and is not synchronised;
// the return value is cudaGetLastError() after the launches (0 on success).
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* b, const void* c,
    void* y, void* state, void* scores, int dtype, int B, int S, int H, int P, int N, int chunk,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || P < 1 || N < 1 || N > NMAX ||
      chunk < 1 || chunk > TMAX || S < chunk || S % chunk)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c, y,
           static_cast<float*>(state), static_cast<float*>(scores), S, H, P, N, chunk,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
           y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
