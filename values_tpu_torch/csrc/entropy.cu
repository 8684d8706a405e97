// K2: one pass over S samples of C classes giving the C2 statistics, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel values_tpu/ops/pallas/entropy.py::_make_kernel
// (entry fused_entropy_pallas). For S softmax samples over C classes at N
// voxels it writes
//
//   mean_softmax (C, N)  m = (1/S) sum_s p_s
//   pred_entropy (N,)    PE = -sum_c m log m
//   expected_entropy (N,) EE = -(1/S) sum_s sum_c p log p
//   mutual_information (N,) MI = PE - EE
//
// where a term with p == 0 counts 0, with the sums in float32. Two forms
// of one templated kernel: the probability form (the JAX kernel's
// contract; float32 or bfloat16 in, outputs in the input's type), and the
// logits form, which applies the float32 softmax over C to each sample as
// it loads (float32 or bfloat16 logits in, float32 out), so the scorer
// hands over the forward's bf16 logits with no cast and no softmax pass.
//
// It reads one layout of an (S, C, N) view, sample-major: sample s's N * C
// values contiguous, classes innermost (strides (ss, 1, C), ss >= N C),
// which is how the forward's grouped 1x1x1 head leaves its
// (B, D, H, W, M, C) logits. The wrapper copies any other layout into it.
//
// What bounds it on an H100: it reads S C values and writes C + 3 per
// voxel and does a few dozen operations per value, so it is bound by
// device memory (0.10 ms for the bf16 logits of a scored batch, 0.15 ms
// for its float32 probabilities). What the design does about it: a strided
// column load per (sample, class) touches a 32-byte sector for every 4
// useful bytes, so a block instead copies a tile of 256 voxels (one
// contiguous run of bytes per sample) into shared memory with
// 16-byte cp.async copies, keeping the next tile's copy in flight while it
// reduces the current one (a persistent grid-stride loop over tiles, two
// stages);
// each thread then reduces its own voxel out of shared memory and writes
// its outputs, neighbouring threads on neighbouring voxels.
//
// Shapes the staged tile cannot hold (more than kMaxC classes, or two
// tiles of S C values a voxel over the shared memory a block may use) run
// a second, streaming regime (fused_entropy_stream_kernel): each thread owns
// one voxel and reads its S samples straight from device memory, per sample
// the max and the sum of exponentials over C in the logits form and then the
// probabilities, accumulating m in float32 in a (C, N) buffer (coalesced:
// neighbouring threads on neighbouring voxels) and EE in a register; PE is
// a final pass over C. It is a correctness regime, not a tuned one: each
// thread's C values are one strided read per class.
//
// The launchers return cudaGetLastError() for the wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 256;       // voxels a tile, threads a block
constexpr int kMaxC = 16;        // classes of the general form

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The SFU's approximate instructions (MUFU), with no range guard.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// p log p, 0 for p == 0; a subnormal p (which lg2.approx.ftz would take
// for 0) adds less than 1e-36 and counts 0 too.
__device__ __forceinline__ float plogp(float p) {
  return p >= 1.17549435e-38f ? kLn2 * p * lg2_approx(p) : 0.0f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy a contiguous run of ``count`` elements to ``dst``: 16-byte copies,
// the ragged end (the last tile only) element by element.
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, int count) {
  const int chunks = count * int(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * i,
               reinterpret_cast<const char*>(src) + 16 * i);
  for (int i = chunks * 16 / int(sizeof(T)) + threadIdx.x; i < count;
       i += blockDim.x)
    dst[i] = src[i];
}

// Copy tile t into ``dst``, one run per sample, laid out
// [sample][voxel][class].
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* x, long long tile,
                                      int n, int S, int C, long long ss) {
  const long long first = tile * kTile;
  const int voxels = int(min((long long)kTile, n - first));
  for (int s = 0; s < S; ++s)
    stage_run(dst + s * kTile * C, x + s * ss + first * C, voxels * C);
}

template <typename T, int CT, bool LOGITS>
__global__ void __launch_bounds__(kTile)
fused_entropy_kernel(const T* __restrict__ x, void* mean_out, void* pe_out,
                     void* ee_out, void* mi_out, int n, int S, int c_rt,
                     long long ss) {
  using Out = typename std::conditional<LOGITS, float, T>::type;
  constexpr int CM = CT ? CT : kMaxC;
  const int C = CT ? CT : c_rt;
  const int row = S * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stages = reinterpret_cast<T*>(smem_raw);   // two tiles of rows
  const long long tiles = (n + kTile - 1) / kTile;
  const float inv_s = 1.0f / float(S);
  long long t = blockIdx.x;
  if (t < tiles) stage(stages, x, t, n, S, C, ss);
  cp_async_commit();
  for (int k = 0; t < tiles; t += gridDim.x, k ^= 1) {
    if (t + gridDim.x < tiles)
      stage(stages + (k ^ 1) * kTile * row, x, t + gridDim.x, n, S, C, ss);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const long long v = t * kTile + threadIdx.x;
    if (v < n) {
      const T* r = stages + k * kTile * row + threadIdx.x * C;
      float m[CM];
#pragma unroll
      for (int c = 0; c < CM; ++c) m[c] = 0.0f;
      float ee = 0.0f;
      for (int s = 0; s < S; ++s) {
        float p[CM];
#pragma unroll
        for (int c = 0; c < CM; ++c)
          if (c < C) p[c] = to_f(r[s * kTile * C + c]);
        if (LOGITS) {   // the float32 softmax over C
          float mx = p[0];
#pragma unroll
          for (int c = 1; c < CM; ++c)
            if (c < C) mx = fmaxf(mx, p[c]);
          float se = 0.0f;
#pragma unroll
          for (int c = 0; c < CM; ++c)
            if (c < C) {
              p[c] = ex2_approx(kLog2e * (p[c] - mx));
              se += p[c];
            }
          const float inv = rcp_approx(se);    // se in [1, C]
#pragma unroll
          for (int c = 0; c < CM; ++c)
            if (c < C) p[c] *= inv;
        }
#pragma unroll
        for (int c = 0; c < CM; ++c)
          if (c < C) {
            m[c] += p[c];
            ee += plogp(p[c]);
          }
      }
      float pe = 0.0f;
#pragma unroll
      for (int c = 0; c < CM; ++c)
        if (c < C) {
          m[c] *= inv_s;
          pe += plogp(m[c]);
          store(static_cast<Out*>(mean_out) + c * (long long)n + v, m[c]);
        }
      pe = -pe;
      ee = -ee * inv_s;
      store(static_cast<Out*>(pe_out) + v, pe);
      store(static_cast<Out*>(ee_out) + v, ee);
      store(static_cast<Out*>(mi_out) + v, pe - ee);
    }
    __syncthreads();   // the stage is refilled next round
  }
}

template <typename T, int CT, bool LOGITS>
int launch(const void* x, void* mean, void* pe, void* ee, void* mi, int n,
           int s, int c, long long ss, cudaStream_t stream) {
  auto kernel = fused_entropy_kernel<T, CT, LOGITS>;
  const int smem = 2 * kTile * s * c * int(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
  }
  // resident blocks on the card, for this instantiation and row size
  static int cached_smem = -1, resident = 0;
  if (smem != cached_smem) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile,
                                                  smem);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_smem = smem;
  }
  const long long tiles = (n + kTile - 1) / kTile;
  const int grid = int(tiles < resident ? tiles : resident);
  kernel<<<grid, kTile, smem, stream>>>(static_cast<const T*>(x), mean, pe,
                                        ee, mi, n, s, c, ss);
  return int(cudaGetLastError());
}

template <typename T, bool LOGITS>
int launch_c(const void* x, void* mean, void* pe, void* ee, void* mi, int n,
             int s, int c, long long ss, cudaStream_t stream) {
  if (c == 2)
    return launch<T, 2, LOGITS>(x, mean, pe, ee, mi, n, s, c, ss, stream);
  return launch<T, 0, LOGITS>(x, mean, pe, ee, mi, n, s, c, ss, stream);
}

// The streaming regime (see the head of the file): any C, any S. ``acc``
// (C, N) float32 holds the running sums of m; it is ``mean_out`` itself when
// the outputs are float32.
template <typename T, bool LOGITS>
__global__ void __launch_bounds__(kTile)
fused_entropy_stream_kernel(const T* __restrict__ x, float* acc,
                            void* mean_out, void* pe_out, void* ee_out,
                            void* mi_out, int n, int S, int C, long long ss) {
  using Out = typename std::conditional<LOGITS, float, T>::type;
  const long long v = blockIdx.x * (long long)kTile + threadIdx.x;
  if (v >= n) return;
  float ee = 0.0f;
  for (int s = 0; s < S; ++s) {
    const T* r = x + s * ss + v * C;
    float mx = 0.0f, inv = 1.0f;
    if (LOGITS) {   // the float32 softmax over C, in two passes
      mx = to_f(r[0]);
      for (int c = 1; c < C; ++c) mx = fmaxf(mx, to_f(r[c]));
      float se = 0.0f;
      for (int c = 0; c < C; ++c) se += ex2_approx(kLog2e * (to_f(r[c]) - mx));
      inv = rcp_approx(se);    // se in [1, C]
    }
    for (int c = 0; c < C; ++c) {
      float p = to_f(r[c]);
      if (LOGITS) p = ex2_approx(kLog2e * (p - mx)) * inv;
      float* a = acc + c * (long long)n + v;
      *a = s == 0 ? p : *a + p;
      ee += plogp(p);
    }
  }
  const float inv_s = 1.0f / float(S);
  float pe = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float m = acc[c * (long long)n + v] * inv_s;
    pe += plogp(m);
    store(static_cast<Out*>(mean_out) + c * (long long)n + v, m);
  }
  pe = -pe;
  ee = -ee * inv_s;
  store(static_cast<Out*>(pe_out) + v, pe);
  store(static_cast<Out*>(ee_out) + v, ee);
  store(static_cast<Out*>(mi_out) + v, pe - ee);
}

template <typename T, bool LOGITS>
int launch_stream(const void* x, float* acc, void* mean, void* pe, void* ee,
                  void* mi, int n, int s, int c, long long ss,
                  cudaStream_t stream) {
  const long long grid = (n + kTile - 1) / kTile;
  fused_entropy_stream_kernel<T, LOGITS><<<unsigned(grid), kTile, 0, stream>>>(
      static_cast<const T*>(x), acc, mean, pe, ee, mi, n, s, c, ss);
  return int(cudaGetLastError());
}

}  // namespace

// ``sample_stride``: the stride between samples, in elements, at least
// n * c and 16-byte aligned, as is ``x``.
extern "C" int fused_entropy_launch(int bf16, int logits, const void* x,
                                    void* mean, void* pe, void* ee, void* mi,
                                    int n, int s, int c,
                                    long long sample_stride, void* stream) {
  if (c < 1 || c > kMaxC || s < 1 || n < 1 ||
      sample_stride < (long long)n * c)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ss = sample_stride;
  if (bf16)
    return logits
        ? launch_c<__nv_bfloat16, true>(x, mean, pe, ee, mi, n, s, c, ss, st)
        : launch_c<__nv_bfloat16, false>(x, mean, pe, ee, mi, n, s, c, ss, st);
  return logits ? launch_c<float, true>(x, mean, pe, ee, mi, n, s, c, ss, st)
                : launch_c<float, false>(x, mean, pe, ee, mi, n, s, c, ss, st);
}

// The streaming regime, for any C: ``acc`` is a (C, N) float32 buffer (the
// mean output itself where the outputs are float32).
extern "C" int fused_entropy_stream_launch(int bf16, int logits,
                                           const void* x, float* acc,
                                           void* mean, void* pe, void* ee,
                                           void* mi, int n, int s, int c,
                                           long long sample_stride,
                                           void* stream) {
  if (c < 1 || s < 1 || n < 1 || sample_stride < (long long)n * c)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ss = sample_stride;
  if (bf16)
    return logits ? launch_stream<__nv_bfloat16, true>(x, acc, mean, pe, ee,
                                                       mi, n, s, c, ss, st)
                  : launch_stream<__nv_bfloat16, false>(x, acc, mean, pe, ee,
                                                        mi, n, s, c, ss, st);
  return logits ? launch_stream<float, true>(x, acc, mean, pe, ee, mi, n, s,
                                             c, ss, st)
                : launch_stream<float, false>(x, acc, mean, pe, ee, mi, n, s,
                                              c, ss, st);
}
