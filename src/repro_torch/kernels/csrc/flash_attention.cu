// Flash attention forward for Hopper (sm_90a): GQA, causal / sliding-window
// masks, optional tanh logit softcap, q_offset, float32 or bfloat16 inputs.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel. It computes
// what repro_torch/kernels/ref.py::attention_ref computes:
//   out = softmax(softcap(scale * Q K^T) + mask) V
// by online softmax (running max m, running sum l, float32 accumulator;
// masked scores are NEG_INF = -1e30, the final l is clamped at 1e-37).
//
// Bound: at prefill lengths the work is the two products, 4 * Sq * Sk * D
// operations per head (halved by a causal mask) against (Sq + 2 Sk) * D
// elements moved, so the kernel is bound by operations, not bytes.
//
// Design. One block of 128 threads owns BQ = 64 query rows of one (batch,
// head) and loops over the key tiles itself, with m, l and the accumulator
// in registers and the Q, K and V tiles staged in shared memory as float32.
// The TPU kernel ran the key axis as a sequential grid dimension with its
// state in VMEM; on the GPU blocks run in no order, so the loop is inside
// the block. Head dims up to 256 are taken as they are (no padding to a
// lane multiple); ragged Sq and Sk are masked here. A kv head is read by
// index (h / group), never replicated. Key tiles in which no row of the
// query tile has a valid key are skipped: for every row that has a valid
// key the result is exact, because the finite NEG_INF of a masked score
// gives exp(NEG_INF - m) = 0 once m is a real score. A tile that holds a
// row without any valid key (a causal row before position 0, or a window
// past the last key) walks every key instead, so that such a row gets the
// mean of V over all Sk keys, as attention_ref gives it. Keys past Sk in
// the last tile are not keys at all: they score -inf and weigh exactly 0.
//
// This first design is simple: every product is a float32 FMA on the CUDA
// cores, so the tensor cores stay unused (no wgmma, no TMA, no pipelining).
// It makes no TF32 rounding and uses full-precision expf / tanhf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int NT = 128;         // threads per block
constexpr int TX = 8;           // threads across keys / head dims
constexpr int TY = NT / TX;     // 16 threads across query rows
constexpr int RQ = BQ / TY;     // 4 query rows per thread
constexpr int RK = BK / TX;     // 4 keys per thread
constexpr int PS = BK + 1;      // row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, group, D;
  long long q_sb, q_ss, q_sh;  // element strides of batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale, softcap;
  int causal, window, q_offset;
};

// Row stride of the Q/K/V tiles: odd, so that threads reading one column of
// different rows hit different banks.
__host__ __device__ __forceinline__ int tile_stride(int D) { return D | 1; }

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd(Params p) {
  constexpr int RD = DMAX / TX;  // head dims per thread in the accumulator
  const int D = p.D;
  const int DP = tile_stride(D);
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;

  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x DP
  float* Ps = Vs + BK * DP;    // BQ x PS

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    Qs[r * DP + d] = s < p.Sq ? to_f32(qg[s * p.q_ss + d]) : 0.f;
  }

  // Key range that holds a valid key for at least one row of this tile;
  // every key when some row of the tile has none.
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int pos_lo = q0 + p.q_offset, pos_hi = q_last + p.q_offset;
  const bool keyless = (p.causal && pos_lo < 0) ||
                       (p.window > 0 && pos_hi - p.window + 1 > p.Sk - 1);
  int k_begin = 0, k_end = p.Sk;
  if (!keyless) {
    if (p.causal) k_end = min(k_end, pos_hi + 1);
    if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1) / BK * BK;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the Q tile is in; the last tile's K, V, P are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      const bool in = s < p.Sk;
      Ks[r * DP + d] = in ? to_f32(kg[s * p.k_ss + d]) : 0.f;
      Vs[r * DP + d] = in ? to_f32(vg[s * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's RQ x RK scores.
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * DP + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = Ks[(tx + TX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Scale, softcap, mask; online-softmax update of each row's m, l, acc.
    // The TX threads that share a row are adjacent lanes of one warp.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + TY * i;
      const int qpos = q0 + r + p.q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = true;
        if (p.causal) ok = qpos >= kpos;
        if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
        s[i][j] = kpos >= p.Sk ? -INFINITY : (ok ? x : NEG_INF);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[r * PS + tx + TX * j] = e;
        rs += e;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's rows and head dims tx + TX * j.
    for (int c = 0; c < BK; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + TY * i) * PS + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int d = tx + TX * j;
        if (d < D) {
          const float vv = Vs[c * DP + d];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty + TY * i;
    if (s >= p.Sq) continue;
    const float li = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + TX * j;
      if (d < D) store(og + s * p.o_ss + d, acc[i][j] / li);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int DP = tile_stride(p.D);
  const size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * DP + (size_t)BQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& p, int B, int H, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, B, H, stream);
  if (p.D <= 128) return launch<T, 128>(p, B, H, stream);
  return launch<T, 256>(p, B, H, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. Tensors are (B, S, heads, D) with
// a unit stride on D; the other strides are in elements. dtype: 0 = float32,
// 1 = bfloat16. The kernel runs on `stream` and is not synchronised; the
// return value is cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int K, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, float softcap, int q_offset,
    void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K || Sq < 1 || Sk < 1 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, Sq, Sk, H / K, D,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale, softcap, causal, window, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_head_dim<float>(p, B, H, s);
  else if (dtype == 1)
    err = dispatch_head_dim<__nv_bfloat16>(p, B, H, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
