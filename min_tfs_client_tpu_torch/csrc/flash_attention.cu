// Dense flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces min_tfs_client_tpu/ops/attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`, launched by the pallas_call at attention.py:204)
// on the port's main path: BERT self-attention through models/layers.py::mha,
// one launch per encoder layer.
//
// Contract (the same as the Pallas kernel's, and as attention_reference's
// without a bias):
//   out = softmax(q k^T * scale) v, q (B,H,Sq,D), k/v (B,H,Skv,D).
//   * Key j of example b is visible iff j < min(lengths[b], Skv). Lengths are
//     clamped to Skv here; the Pallas wrapper instead pads Skv to 128 with zero
//     keys, so a length past an unaligned Skv would attend those zero keys
//     there. The port follows attention_reference. No caller reaches the case.
//   * Causal: query row i (absolute position q_offset + i) sees key j iff
//     q_offset + i >= j; KV tiles wholly above the diagonal are skipped.
//   * Scores use a finite NEG_INF (-1e30), never -INFINITY: exp(-inf - -inf)
//     is NaN. A row whose running max never left NEG_INF writes zeros.
//   * q is scaled in f32 before the product (attention.py:92); the running
//     max, denominator and accumulator are f32; the output is q's dtype.
//
// Design: one block of 256 threads per (b*h, 64-row Q tile). The block keeps
// its Q tile in shared memory and loops over 64-key K/V tiles staged in shared
// memory, carrying the online-softmax state (m, l) in shared memory and the
// 64 x D accumulator in registers (a 4 x D/16 slice per thread). Products are
// plain f32 FMAs on the CUDA cores; wgmma/TMA are later work. Inputs may have
// any strides over (b, h, s) as long as the head dim is contiguous, so mha
// passes its head-split views without a copy and gets its output back in the
// (B, Sq, H, D) layout the out projection reads.
//
// Bound on an H100 SXM at the main path's shape (32,12,128,64) bf16: it must
// read q, k, v and write o, 4 x 6.29 MB = 25.2 MB, about 7.5 us at 3.35 TB/s,
// against 1.61 GFLOP, about 1.6 us of bf16 tensor-core time; so it is bound by
// bytes. This first version is simple and correct, not fast: its f32 FMA
// inner loops run far below both bounds.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kLdS = kBlockN + 1;  // padded row stride of the score tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* lengths;  // (B,) or null: every key is valid
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, Sq, Skv, D;
  float scale;
  int causal;
  int q_offset;  // absolute key position of query row 0 (causal only)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  // Q, K, V tiles (padded rows), the score tile, and per-row m, l, corr.
  return sizeof(float) * ((kBlockM + 2 * kBlockN) * (DMAX + 1) +
                          kBlockM * kLdS + 3 * kBlockM);
}

// Stage rows [row0, row0 + rows) of a (S, D) slab into a zero-padded
// (rows, DMAX) f32 tile with row stride DMAX + 1, scaled by `mul`.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0, int rows,
                                          int seq, int d, float mul) {
  constexpr int ld = DMAX + 1;
  for (int e = threadIdx.x; e < rows * DMAX; e += kThreads) {
    const int r = e / DMAX;
    const int c = e % DMAX;
    float x = 0.f;
    if (row0 + r < seq && c < d) {
      x = to_f32(src[(long long)(row0 + r) * stride + c]) * mul;
    }
    dst[r * ld + c] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  constexpr int ld = DMAX + 1;
  constexpr int kCols = DMAX / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockM * ld;
  float* sV = sK + kBlockN * ld;
  float* sS = sV + kBlockN * ld;
  float* sM = sS + kBlockM * kLdS;
  float* sL = sM + kBlockM;
  float* sC = sL + kBlockM;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int m0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // owns rows ty + 16 i
  const int tx = tid % 16;  // owns key / head-dim columns tx + 16 j

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  int valid = p.Skv;
  if (p.lengths != nullptr) {
    valid = min(max(p.lengths[b], 0), p.Skv);
  }
  // KV tiles to visit: none past the last valid key, none wholly above the
  // causal diagonal of this Q tile (attention.py:128-133). Skipped tiles hold
  // only masked keys, which contribute nothing once a row sees a valid key,
  // and a row that never does writes zeros either way.
  int n_run = (valid + kBlockN - 1) / kBlockN;
  if (p.causal) {
    const long long q_end = (long long)p.q_offset + m0 + kBlockM;
    const long long diag = q_end <= 0 ? 0 : (q_end + kBlockN - 1) / kBlockN;
    n_run = (int)min((long long)n_run, diag);
  }

  load_tile<T, DMAX>(sQ, q, p.q_ss, m0, kBlockM, p.Sq, p.D, p.scale);
  if (tid < kBlockM) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_run; ++t) {
    const int n0 = t * kBlockN;
    __syncthreads();  // the previous tile's readers are done with sK/sV/sS
    load_tile<T, DMAX>(sK, k, p.k_ss, n0, kBlockN, p.Skv, p.D, 1.f);
    load_tile<T, DMAX>(sV, v, p.v_ss, n0, kBlockN, p.Skv, p.D, 1.f);
    __syncthreads();

    // Scores for rows ty + 16 i and keys tx + 16 j, masked to NEG_INF.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < p.D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int key = n0 + c;
        bool ok = key < valid;
        if (p.causal) ok = ok && (p.q_offset + m0 + r >= key);
        sS[r * kLdS + c] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax, four threads per row (neighbouring lanes of one warp).
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float mx = kNegInf;
      for (int c = part; c < kBlockN; c += 4) mx = fmaxf(mx, sS[r * kLdS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float l_prev = sL[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBlockN; c += 4) {
        const float e = expf(sS[r * kLdS + c] - m_new);
        sS[r * kLdS + c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = corr * l_prev + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    for (int n = 0; n < kBlockN; ++n) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sS[(ty + 16 * i) * kLdS + n];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = sV[n * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // sM/sL final (also when no tile ran)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = m0 + r;
    if (row >= p.Sq) continue;
    const float m = sM[r];
    float l = sL[r];
    const bool row_valid = m > kNegInf * 0.5f;
    if (l == 0.f) l = 1.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < p.D) {
        o[(long long)row * p.o_ss + c] =
            from_f32<T>(row_valid ? acc[i][j] / l : 0.f);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  // Above 48 KB dynamic shared memory must be opted into, once per kernel.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.H, (p.Sq + kBlockM - 1) / kBlockM);
  flash_attention_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements; the head
// dim is contiguous in every tensor. Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream` and allocates nothing.
extern "C" int flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o,
    const int32_t* lengths, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int B, int H, int Sq, int Skv, int D, float scale,
    int causal, int q_offset, void* stream) {
  if (D <= 0 || D % 8 != 0 || D > 128) return (int)cudaErrorInvalidValue;
  if ((Sq + kBlockM - 1) / kBlockM > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lengths = lengths;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.B = B; p.H = H; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_for_dim<float>(p, s);
    case 1: return (int)launch_for_dim<__half>(p, s);
    case 2: return (int)launch_for_dim<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
