// The SSN's sampling stage for Hopper (sm_90a): the capacitance of a batch
// of low-rank normals and their softmaxed samples, as the 2D tester draws
// them for a Stochastic Segmentation Network.
//
// It replaces no TPU kernel. The JAX package samples the SSN in XLA
// (values_tpu/models/ssn_unet3d.py::LowRankMVN: an einsum, then the
// softmax), and the port ran the same composition in PyTorch: cuBLAS's
// float32 capacitance product (W / D)^T W, the where-copy of the factor,
// the low-rank einsum, the three-term sum and torch.softmax over the
// strided class axis, each through a 0.7 GB temporary. At the 2D SSN's
// shape (B 6 images, C 24 classes, H x W 256 x 478, rank R 10, S 10
// samples) that took 37.2 ms of device time a batch, 31.0 of them the
// capacitance product (cuBLAS's gemmSN_TN_kernel, a GEMV-shaped product
// over K = N = 2.94 M).
//
// For B low-rank normals over N = C * HW logits (mean and diagonal D
// (B, N), factor W (B, N, R), logit n = c * HW + p, any strides; float32
// or float64, T below) it computes
//
//   cap[b]          = I + W[b]^T D[b]^-1 W[b]                   (B, R, R)
//   out[s, b, :, p] = softmax_c(mean + W eps_r[s, b] + sqrt(D) eps_d[s, b])
//
// with out (S, B, C, HW) in T. The capacitance is float32 whatever T, as
// LowRankMVN.degenerate forms it: each value is rounded to float32 as it
// is read. The wrapper (values_tpu_torch/ops/kernels/
// ssn_sample.py) draws eps_r (S, B, R) and eps_d (S, B, N) with torch.randn
// from the caller's generator, takes the Cholesky of cap
// (torch.linalg.cholesky_ex) for the degenerate flags and hands them to
// the sample kernel, which leaves a flagged image's low-rank term out:
// skipped, not multiplied by 0, so a non-finite factor leaves no NaN.
//
// What bounds it on an H100: bytes. Per image the stage reads the factor
// (R floats a logit) twice (the capacitance, the samples), the mean, the
// diagonal and eps_d (S floats a logit), and writes S softmax values a
// logit: ~3.0 GB a batch at the 2D shape, ~0.9 ms at 3.35 TB/s. The
// arithmetic, R FMAs and one exp a logit and sample, is a few percent of
// the float32 peak. What the design does about it:
// * capacitance: each thread sums the R (R + 1) / 2 products of the lower
//   triangle over 32 logits in registers (R a template parameter, 1 to
//   kMaxRank), loading 4 logits' factor rows before it sums them; a block
//   reduces its sums in a fixed order (a warp butterfly, then the warps in
//   turn) into one partial, and a second kernel adds a batch item's
//   partials, a warp an entry, in a fixed order. No atomics: the sums are
//   the same from run to run.
// * samples: a block owns kSampleThreads / LP pixels of one image; LP
//   lanes share a pixel, each holding cpt = ceil(C / LP) <= kMaxCpt
//   classes, laid out so that a warp's access to one class covers 32 / LP
//   neighbouring pixels (whole 32-byte sectors). A thread copies its
//   classes' factor values once into its own column of shared memory
//   (cp.async: no registers, no bank conflicts, no barrier), and eps_d
//   into a ring of kDepth samples there, fetched kDepth - 1 samples ahead;
//   mean and sqrt(D) stay in registers. For each of the S samples it forms
//   its logits, takes the softmax (max and sum over the pixel's LP lanes
//   by shuffles, exp(l - max) / sum as torch.softmax forms it) and stores
//   it with the streaming hint.
//
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W) at the 2D shape: the
// capacitance 0.40 ms, the sample kernel 1.6-1.7 ms (~1.4 TB/s; a torch
// copy_ moves 2.9 TB/s). The sample kernel is held back by latency, not
// by instructions: the factor's 960 bytes a pixel in shared memory bound
// the pixels resident on an SM to ~190 (5-6 blocks of 128 threads), and
// a deeper ring or bigger blocks measured slower. A layout with a lane a
// pixel and a warp a sample (the block's factor staged once for all its
// samples) ran at 2.8 ms: 108 registers a thread left one block an SM.
//
// float64 inputs (the 2D tester's --dtype float64) run the same kernels
// on doubles, with twice the shared memory a pixel; their capacitance is
// still float32. Each launcher returns cudaGetLastError() for the wrapper
// to raise on.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCapThreads = 256;
constexpr int kCapItems = 32;                       // logits a thread sums
constexpr int kCapBatch = 4;                        // loaded before summed
constexpr int kCapChunk = kCapThreads * kCapItems;  // logits a block sums
constexpr int kFinishWarps = 8;
constexpr int kMaxRank = 16;
constexpr int kSampleThreads = 128;
constexpr int kMaxCpt = 8;                          // classes a thread holds
constexpr int kDepth = 2;                  // samples of eps_d being fetched
constexpr long long kSmemLimit = 232448;            // bytes a block may use

// the math functions of T: float's are the f-suffixed ones
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) {
  return fmax(a, b);
}

template <int R, typename T>
__global__ void __launch_bounds__(kCapThreads)
capacitance_partial_kernel(const T* __restrict__ factor,
                           const T* __restrict__ diag,
                           float* __restrict__ partial, long long n,
                           long long f_sb, long long f_sn, long long f_sr,
                           long long d_sb, long long d_sn) {
  // the lower triangle, row-major: q = i (i + 1) / 2 + j for j <= i
  constexpr int P = R * (R + 1) / 2;
  const int b = blockIdx.y;
  const T* fb = factor + b * f_sb;
  const T* db = diag + b * d_sb;
  float acc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q] = 0.f;
  const long long first = (long long)blockIdx.x * kCapChunk + threadIdx.x;
  for (int k0 = 0; k0 < kCapItems; k0 += kCapBatch) {
    // a batch's loads all in flight before its sums; a logit past n
    // adds (0 / 1) * 0
    float w[kCapBatch][R], d[kCapBatch];
#pragma unroll
    for (int u = 0; u < kCapBatch; ++u) {
      const long long i = first + (long long)(k0 + u) * kCapThreads;
      const bool in = i < n;
      d[u] = in ? float(db[i * d_sn]) : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        w[u][r] = in ? float(__ldcs(fb + i * f_sn + r * f_sr)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCapBatch; ++u) {
      float wd[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        wd[r] = w[u][r] / d[u];  // (W / D)^T W, as the plain version forms it
      int q = 0;
#pragma unroll
      for (int r0 = 0; r0 < R; ++r0)
#pragma unroll
        for (int r1 = 0; r1 <= r0; ++r1, ++q)
          acc[q] = fmaf(wd[r0], w[u][r1], acc[q]);
    }
  }
  __shared__ float red[kCapThreads / 32][P];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    float v = acc[q];
#pragma unroll
    for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < P; q += kCapThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kCapThreads / 32; ++w) v += red[w][q];
    partial[((long long)b * gridDim.x + blockIdx.x) * P + q] = v;
  }
}

// One warp an entry q of one batch item: lane l adds partials l, l + 32,
// ... in order, then a butterfly; the diagonal gains the identity's 1.
__global__ void __launch_bounds__(kFinishWarps * 32)
capacitance_finish_kernel(const float* __restrict__ partial,
                          float* __restrict__ cap, int blocks, int r) {
  const int p = r * (r + 1) / 2;
  const int b = blockIdx.y;
  const int q = blockIdx.x * kFinishWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= p) return;            // the whole warp
  const float* src = partial + (long long)b * blocks * p + q;
  float v = 0.f;
  for (int k = lane; k < blocks; k += 32) v += src[(long long)k * p];
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) {
    int i = 0, j = q;
    while (j > i) j -= ++i;
    float* cb = cap + (long long)b * r * r;
    const float x = (i == j ? 1.f : 0.f) + v;
    cb[i * r + j] = x;
    cb[j * r + i] = x;
  }
}

// capacitance_partial_kernel<r, T>, r in 1 .. kMaxRank
template <typename T, int R = 1>
void launch_partial(int r, dim3 grid, cudaStream_t stream, const T* factor,
                    const T* diag, float* partial, long long n,
                    long long f_sb, long long f_sn, long long f_sr,
                    long long d_sb, long long d_sn) {
  if constexpr (R < kMaxRank) {
    if (r != R)
      return launch_partial<T, R + 1>(r, grid, stream, factor, diag, partial,
                                      n, f_sb, f_sn, f_sr, d_sb, d_sn);
  }
  capacitance_partial_kernel<R, T><<<grid, kCapThreads, 0, stream>>>(
      factor, diag, partial, n, f_sb, f_sn, f_sr, d_sb, d_sn);
}

template <typename T>
struct SampleArgs {
  const T* mean;
  const T* diag;
  const T* factor;
  const unsigned char* degenerate;
  const T* eps_r;
  const T* eps_d;
  T* out;
  int s, b, c, r, cpt;
  long long hw;
  long long m_sb, m_sn, d_sb, d_sn, f_sb, f_sn, f_sr;
  long long er_ss, er_sb, er_sr, ed_ss, ed_sb, ed_sn;
};

template <int LP, typename T>
__global__ void __launch_bounds__(kSampleThreads)
sample_softmax_kernel(const SampleArgs<T> a) {
  constexpr int kPpw = 32 / LP;                    // pixels a warp covers
  constexpr int K = kSampleThreads;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  // eps_r[:, b, :] (S, R); then per thread, in its own column (stride K):
  // its classes' factor (cpt, R) and a ring of kDepth samples' eps_d
  T* er = smem;
  T* wcol = smem + a.s * a.r + threadIdx.x;
  T* edcol = wcol + a.cpt * a.r * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const long long p = (long long)blockIdx.x * (K / LP) + warp * kPpw
                      + lane % kPpw;
  const int c0 = (lane / kPpw) * a.cpt;            // the thread's classes
  const bool pixel = p < a.hw;
  const bool low_rank = !a.degenerate[b];
  const T* ed_b = a.eps_d + b * a.ed_sb;
  bool cls[kMaxCpt], on[kMaxCpt];
#pragma unroll
  for (int j = 0; j < kMaxCpt; ++j) {
    cls[j] = j < a.cpt && c0 + j < a.c;
    on[j] = pixel && cls[j];
  }

  // asynchronous copies, one commit group each: the factor, then eps_d of
  // the first kDepth - 1 samples; the loop fetches kDepth - 1 ahead
  if (low_rank)
    for (int j = 0; j < a.cpt; ++j)
      if (on[j]) {
        const T* f = a.factor + b * a.f_sb
                         + ((long long)(c0 + j) * a.hw + p) * a.f_sn;
        for (int r = 0; r < a.r; ++r)
          __pipeline_memcpy_async(wcol + (j * a.r + r) * K, f + r * a.f_sr,
                                  sizeof(T));
      }
  __pipeline_commit();
  auto fetch = [&](int s) {
    if (s < a.s)
      for (int j = 0; j < a.cpt; ++j)
        if (on[j])
          __pipeline_memcpy_async(
              edcol + ((s % kDepth) * a.cpt + j) * K,
              ed_b + s * a.ed_ss
                  + ((long long)(c0 + j) * a.hw + p) * a.ed_sn,
              sizeof(T));
    __pipeline_commit();
  };
  for (int s = 0; s < kDepth - 1; ++s) fetch(s);

  T mean[kMaxCpt], sd[kMaxCpt];
#pragma unroll
  for (int j = 0; j < kMaxCpt; ++j) {
    const long long n = (long long)(c0 + j) * a.hw + p;
    mean[j] = on[j] ? a.mean[b * a.m_sb + n * a.m_sn] : T(0);
    sd[j] = on[j] ? sqrt_(a.diag[b * a.d_sb + n * a.d_sn]) : T(0);
  }
  for (int i = threadIdx.x; i < a.s * a.r; i += K)
    er[i] = a.eps_r[(i / a.r) * a.er_ss + b * a.er_sb + (i % a.r) * a.er_sr];
  __syncthreads();                                 // er is staged

  T* out_b = a.out + (long long)b * a.c * a.hw;
  const long long out_ss = (long long)a.b * a.c * a.hw;
  for (int s = 0; s < a.s; ++s) {
    fetch(s + kDepth - 1);
    __pipeline_wait_prior(kDepth - 1);             // sample s has landed
    // W eps_r, over r in order; each eps_r value read once (a broadcast)
    T l[kMaxCpt];
#pragma unroll
    for (int j = 0; j < kMaxCpt; ++j) l[j] = T(0);
    if (low_rank) {
      const T* ers = er + s * a.r;
      for (int r = 0; r < a.r; ++r) {
        const T e = ers[r];
#pragma unroll
        for (int j = 0; j < kMaxCpt; ++j)
          if (j < a.cpt) l[j] = fma_(wcol[(j * a.r + r) * K], e, l[j]);
      }
    }
    const T* eds = edcol + (s % kDepth) * a.cpt * K;
    T m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxCpt; ++j) {
      const T ed = on[j] ? eds[j * K] : T(0);
      l[j] = cls[j] ? fma_(sd[j], ed, mean[j] + l[j]) : T(-INFINITY);
      m = max_(m, l[j]);
    }
#pragma unroll
    for (int off = kPpw; off < 32; off <<= 1)
      m = max_(m, __shfl_xor_sync(kFull, m, off));
    T sum = 0;
#pragma unroll
    for (int j = 0; j < kMaxCpt; ++j) {
      l[j] = cls[j] ? exp_(l[j] - m) : T(0);
      sum += l[j];
    }
#pragma unroll
    for (int off = kPpw; off < 32; off <<= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    T* out_s = out_b + s * out_ss;
#pragma unroll
    for (int j = 0; j < kMaxCpt; ++j)
      if (on[j]) __stcs(out_s + (long long)(c0 + j) * a.hw + p, l[j] / sum);
  }
}

template <int LP, typename T>
int launch_sample(const SampleArgs<T>& a, cudaStream_t stream) {
  const long long smem =
      (long long)sizeof(T) * ((long long)a.s * a.r
             + (long long)a.cpt * (a.r + kDepth) * kSampleThreads);
  if (smem > kSmemLimit) return int(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      sample_softmax_kernel<LP, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  constexpr int pixels = kSampleThreads / LP;
  const dim3 grid(unsigned((a.hw + pixels - 1) / pixels), unsigned(a.b));
  sample_softmax_kernel<LP, T><<<grid, kSampleThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_sample(int lanes, const SampleArgs<T>& a, cudaStream_t st) {
  switch (lanes) {
    case 1: return launch_sample<1>(a, st);
    case 2: return launch_sample<2>(a, st);
    case 4: return launch_sample<4>(a, st);
    case 8: return launch_sample<8>(a, st);
    case 16: return launch_sample<16>(a, st);
    case 32: return launch_sample<32>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Partials a batch item's capacitance sums over n logits: one a block.
extern "C" long long ssn_capacitance_blocks(long long n) {
  return (n + kCapChunk - 1) / kCapChunk;
}

// double_ (0 or 1) says whether factor and diag (the capacitance's
// inputs), or mean, diag, factor, eps_r, eps_d and out (the samples'), are
// float32 or float64.
extern "C" int ssn_capacitance_launch(
    int double_, const void* factor, const void* diag, float* partial,
    float* cap, int b, long long n, int r, long long f_sb, long long f_sn,
    long long f_sr, long long d_sb, long long d_sn, void* stream) {
  const long long blocks = ssn_capacitance_blocks(n);
  if (r < 1 || r > kMaxRank || b < 1 || b > 65535 || n < 1 ||
      blocks > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  if (double_)
    launch_partial(r, grid, s, static_cast<const double*>(factor),
                   static_cast<const double*>(diag), partial, n, f_sb, f_sn,
                   f_sr, d_sb, d_sn);
  else
    launch_partial(r, grid, s, static_cast<const float*>(factor),
                   static_cast<const float*>(diag), partial, n, f_sb, f_sn,
                   f_sr, d_sb, d_sn);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int entries = r * (r + 1) / 2;
  capacitance_finish_kernel<<<
      dim3((entries + kFinishWarps - 1) / kFinishWarps, unsigned(b)),
      kFinishWarps * 32, 0, s>>>(partial, cap, int(blocks), r);
  return int(cudaGetLastError());
}

namespace {

template <typename T>
int sample_softmax_launch(
    int lanes, int cpt, const void* mean, const void* diag,
    const void* factor, const unsigned char* degenerate, const void* eps_r,
    const void* eps_d, void* out, int s, int b, int c, long long hw, int r,
    const long long* st, cudaStream_t stream) {
  const SampleArgs<T> a{
      static_cast<const T*>(mean),  static_cast<const T*>(diag),
      static_cast<const T*>(factor), degenerate,
      static_cast<const T*>(eps_r), static_cast<const T*>(eps_d),
      static_cast<T*>(out), s, b, c, r, cpt, hw, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12]};
  return dispatch_sample(lanes, a, stream);
}

}  // namespace

extern "C" int ssn_sample_softmax_launch(
    int double_, int lanes, int cpt, const void* mean, const void* diag,
    const void* factor, const unsigned char* degenerate, const void* eps_r,
    const void* eps_d, void* out, int s, int b, int c, long long hw, int r,
    long long m_sb, long long m_sn, long long d_sb, long long d_sn,
    long long f_sb, long long f_sn, long long f_sr, long long er_ss,
    long long er_sb, long long er_sr, long long ed_ss, long long ed_sb,
    long long ed_sn, void* stream) {
  if (cpt < 1 || cpt > kMaxCpt || (long long)cpt * lanes < c || s < 1 ||
      b < 1 || b > 65535 || c < 1 || r < 1 || hw < 1)
    return int(cudaErrorInvalidValue);
  const long long st[13] = {m_sb, m_sn, d_sb, d_sn, f_sb, f_sn, f_sr,
                            er_ss, er_sb, er_sr, ed_ss, ed_sb, ed_sn};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return double_
      ? sample_softmax_launch<double>(lanes, cpt, mean, diag, factor,
                                      degenerate, eps_r, eps_d, out, s, b, c,
                                      hw, r, st, cs)
      : sample_softmax_launch<float>(lanes, cpt, mean, diag, factor,
                                     degenerate, eps_r, eps_d, out, s, b, c,
                                     hw, r, st, cs);
}
