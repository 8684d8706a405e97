// K3: streaming sampled-softmax statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel values_tpu/ops/pallas/sampling.py::
// _sample_stats_kernel (entry sampled_softmax_stats). For the heads of M
// members at N voxels over C classes it draws n_samples logit vectors per
// member, logits = mu + sigma * z with z ~ N(0, 1), and writes
//
//   sum_p   (C, N)  the sum over members x samples of softmax(logits)
//   sum_ent (N,)    the sum of the per-sample entropies -sum_c p log p
//
// in float32. The scale comes as sigma, or as the head's log-variance s
// with sigma = exp(s / 2) formed in float32 right after the load; mu and
// the scale are float32 or bfloat16 (N, M, C) views of any strides, so
// the aleatoric scorer hands over the forward's bf16 head as it is.
//
// The draw: uint32 bits -> u = top 24 bits * 2^-24 + 2^-26 -> Acklam's
// inverse normal CDF. Two bit sources (values_tpu_torch/ops/kernels/
// sampling.py holds the plain version of each):
// * Philox4x32-10, key (seed mod 2^32, seed >> 32), counter (n, m, j / 4,
//   0) with j = i * C + c; draw (i, c) takes word j mod 4, so every word
//   of every call is used (5 calls per voxel and member at C = 2, 10
//   samples);
// * the JAX package's counter_bits hash at the JAX kernel's packed
//   indices, for value-for-value parity with the TPU kernel.
//
// What bounds it on an H100: per voxel it reads 2 M C head values and
// writes C + 1 floats, 0.13 ms of bytes at the aleatoric path's shape
// (bf16 head, N 8.4 M, M 5, C 2), but draws M n C normals: ~52 G
// operations, 0.77 ms at the f32 peak. The floor below that is the SFU
// (MUFU: 16 results per clock per SM against 128 f32 FMAs): a draw group
// of C = 2 needs an exp, a log and a reciprocal for the softmax and the
// entropy, a reciprocal per central Acklam division, a log, a sqrt and a
// reciprocal for a tail draw (4.85% of draws), and one exp per (voxel,
// member, class) for sigma: ~5.5 MUFU operations per group, ~0.6 ms.
// What the design does about it:
// * one thread owns a voxel and loops over members and samples in
//   registers (C + 1 float32 accumulators): each head byte is read once,
//   each output written once and coalesced ((C, N) rows), no atomics;
// * every Philox word is used, and a 32 x 32 -> 64-bit multiply gives
//   both halves of each Philox product;
// * Acklam's branches run where they apply. The central one on every draw
//   (95% of them), in __fmul_rn / __fadd_rn in the plain version's order,
//   so that no contraction moves it (ROADMAP fault R4: it cancels ~180-fold
//   near its edges in float32); everything else builds with nvcc's default
//   contraction. The tail (a log, a sqrt, a rational) runs under a warp
//   vote: with 32 lanes ~79% of warp-steps hold a tail draw, yet gathering
//   the warp's tail draws through shared memory and computing each once
//   measured slower on the H100 (ballots, shared-memory traffic and warp
//   barriers on every draw cost more than the tails they save);
// * the transcendentals are the SFU's approximate instructions (ex2, lg2,
//   rcp, sqrt .approx.ftz) with no range guard: every argument is normal
//   and in range, and the guards of the library forms (a compare, a
//   scaling and a branch each) cost more than the MUFU itself;
// * at C = 2 the softmax and entropy take one exp, one log and one
//   reciprocal: with d = l1 - l0 and t = e^-|d|, p_max = 1 / (1 + t) and
//   H = log(1 + t) + |d| t / (1 + t); other C take the log-sum-exp form.
//
// More than kMaxC classes run a third kernel (sampled_stats_wide_kernel),
// a correctness regime: the same draws per (voxel, member, sample, class),
// each thread's per-class values (a sample's logits, the member's mu and
// scale, the softmax sums) in shared memory (4 C floats a thread, the
// block made smaller where 256 threads' would not fit), sum_p written once
// (thread-owned, coalesced).
//
// The bits kernel writes the draws' bits from the same device functions,
// so the bits are checked exactly against the plain version on the card.
//
// Each launcher returns cudaGetLastError() for the wrapper to raise on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxC = 8;         // classes of the general form

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The SFU's approximate instructions (MUFU), one each, with no range
// guard: the callers keep their arguments normal and in range.
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
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Philox4x32-10 (Salmon et al. 2011, Random123)
__device__ __forceinline__ uint4 philox(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 = 0xD2511F53ull * c.x;
    const unsigned long long p1 = 0xCD9E8D57ull * c.z;
    const unsigned hi0 = unsigned(p0 >> 32), lo0 = unsigned(p0);
    const unsigned hi1 = unsigned(p1 >> 32), lo1 = unsigned(p1);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ unsigned word_of(uint4 w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// The JAX package's counter_bits hash (murmur3 finalizer), all mod 2^32.
__device__ __forceinline__ unsigned hash32(unsigned flat, unsigned seed,
                                           unsigned salt) {
  unsigned x = flat ^ (seed * 0x9E3779B9u);
  x += salt * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Where a voxel's bits come from: the key and voxel counter for Philox;
// the packed flat index of class 0 and the salt base for the hash.
struct Source {
  unsigned k0, k1, n, flat0, salt0;
  int c;
};

__device__ __forceinline__ Source make_source(bool counter, int n, int m,
                                              int c, unsigned k0,
                                              unsigned k1, int D, int H,
                                              int W, int rows) {
  Source s{k0, k1, unsigned(n), 0u, 0u, c};
  if (counter) {
    const int wi = n % W, t0 = n / W;
    const int hi = t0 % H, t1 = t0 / H;
    const int di = t1 % D, bi = t1 / D;
    const int bp = 128 / W;
    const int lane = (bi % bp) * W + wi;
    s.flat0 = unsigned(((di % rows) * H + hi) * c * 128 + lane);
    s.salt0 = unsigned(((bi / bp) * (D / rows) + di / rows) * m);
  }
  return s;
}

// The bits of draw (i, c) of member m in counter mode.
__device__ __forceinline__ unsigned counter_word(const Source& s, int m,
                                                 int i, int c) {
  return hash32(s.flat0 + unsigned(c) * 128u, s.k0 + unsigned(i),
                s.salt0 + unsigned(m));
}

// Four consecutive draws j = 4g .. 4g + 3 (j = i C + c) of member m.
template <bool COUNTER>
__device__ __forceinline__ uint4 draw4(const Source& s, int m, int g) {
  if (COUNTER) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * g + k;
      w[k] = counter_word(s, m, j / s.c, j % s.c);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  return philox(make_uint4(s.n, unsigned(m), unsigned(g), 0u), s.k0, s.k1);
}

__device__ __forceinline__ float uniform(unsigned bits) {
  return __fadd_rn(__fmul_rn(float(bits >> 8), 1.0f / 16777216.0f),
                   0.5f / 33554432.0f);
}

// Acklam's central branch, rounded at every step in the plain version's
// order (fault R4); its final division may round apart by an ulp.
__device__ __forceinline__ float acklam_central(float u) {
  const float q = __fsub_rn(u, 0.5f);
  const float r = __fmul_rn(q, q);
  float num = -3.969683028665376e+01f;
  num = __fadd_rn(__fmul_rn(num, r), 2.209460984245205e+02f);
  num = __fadd_rn(__fmul_rn(num, r), -2.759285104469687e+02f);
  num = __fadd_rn(__fmul_rn(num, r), 1.383577518672690e+02f);
  num = __fadd_rn(__fmul_rn(num, r), -3.066479806614716e+01f);
  num = __fadd_rn(__fmul_rn(num, r), 2.506628277459239e+00f);
  float den = -5.447609879822406e+01f;
  den = __fadd_rn(__fmul_rn(den, r), 1.615858368580409e+02f);
  den = __fadd_rn(__fmul_rn(den, r), -1.556989798598866e+02f);
  den = __fadd_rn(__fmul_rn(den, r), 6.680131188771972e+01f);
  den = __fadd_rn(__fmul_rn(den, r), -1.328068155288572e+01f);
  den = __fadd_rn(__fmul_rn(den, r), 1.0f);   // in [0.0026, 1]
  return __fmul_rn(num, q) * rcp_approx(den);
}

// The shared lower/upper tail: q = sqrt(-2 log(min(u, 1 - u))); the upper
// tail is the lower one's negative.
__device__ __forceinline__ float acklam_tail(float u) {
  const bool lower = u < 0.5f;
  // min(u, 1 - u) >= 2^-26: normal, and its log a few dozen at most
  const float q = sqrt_approx(-2.0f * kLn2 * lg2_approx(lower ? u : 1.0f - u));
  const float num = ((((-7.784894002430293e-03f * q - 3.223964580411365e-01f)
                       * q - 2.400758277161838e+00f) * q
                      - 2.549732539343734e+00f) * q + 4.374664141464968e+00f)
                    * q + 2.938163982698783e+00f;
  const float den = (((7.784695709041462e-03f * q + 3.224671290700398e-01f)
                      * q + 2.445134137142996e+00f) * q
                     + 3.754408661907416e+00f) * q + 1.0f;
  const float t = num * rcp_approx(den);      // den >= 36
  return lower ? t : -t;
}

__device__ __forceinline__ bool in_tail(float u) {
  return u < 0.02425f || u > 0.97575f;   // PLOW, 1 - PLOW
}

// One normal per lane; the tail under a warp vote. All 32 lanes call it.
__device__ __forceinline__ float normal_vote(unsigned bits) {
  const float u = uniform(bits);
  float z = acklam_central(u);
  const bool tail = in_tail(u);
  if (__any_sync(kFull, tail)) {
    const float zt = acklam_tail(u);
    if (tail) z = zt;
  }
  return z;
}

// softmax and entropy of two logits: one exp, one log, one reciprocal.
__device__ __forceinline__ void two_class(float l0, float l1, float& p0,
                                          float& p1, float& ent) {
  const float d = l1 - l0;
  const float ad = fabsf(d);
  const float t = ex2_approx(-kLog2e * ad);   // in [0, 1]
  const float s = 1.0f + t;                   // in [1, 2]
  const float big = rcp_approx(s);
  const float small = t * big;
  p0 = d >= 0.0f ? small : big;
  p1 = d >= 0.0f ? big : small;
  ent = kLn2 * lg2_approx(s) + ad * small;
}

template <typename T, bool LOGVAR>
__device__ __forceinline__ float load_scale(const T* p) {
  const float v = load_f(p);
  return LOGVAR ? expf(v * 0.5f) : v;
}

struct Args {
  const void* mu;
  const void* scale;
  float* sum_p;
  float* sum_ent;
  int n, m, c, n_samples;
  unsigned k0, k1;
  long long smu_n, smu_m, smu_c, ssc_n, ssc_m, ssc_c;
  int D, H, W, rows;
};

// C = 2: each Philox call (or four hashes) gives samples 2g and 2g + 1.
template <bool COUNTER, bool LOGVAR, typename T>
__global__ void __launch_bounds__(256)
sampled_stats_c2_kernel(Args a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < a.n;
  const int n = live ? idx : a.n - 1;        // whole warps draw
  const Source src = make_source(COUNTER, n, a.m, 2, a.k0, a.k1, a.D, a.H,
                                 a.W, a.rows);
  const T* mu = static_cast<const T*>(a.mu) + n * a.smu_n;
  const T* sc = static_cast<const T*>(a.scale) + n * a.ssc_n;
  float acc0 = 0.0f, acc1 = 0.0f, acc_e = 0.0f;
  const int calls = (a.n_samples + 1) / 2;
  for (int im = 0; im < a.m; ++im) {
    const float mu0 = load_f(mu + im * a.smu_m);
    const float mu1 = load_f(mu + im * a.smu_m + a.smu_c);
    const float s0 = load_scale<T, LOGVAR>(sc + im * a.ssc_m);
    const float s1 = load_scale<T, LOGVAR>(sc + im * a.ssc_m + a.ssc_c);
    for (int g = 0; g < calls; ++g) {
      const uint4 w = draw4<COUNTER>(src, im, g);
      const bool second = 2 * g + 1 < a.n_samples;
      float z[4];
      z[0] = normal_vote(w.x);
      z[1] = normal_vote(w.y);
      if (second) {
        z[2] = normal_vote(w.z);
        z[3] = normal_vote(w.w);
      }
      float p0, p1, ent;
      two_class(mu0 + s0 * z[0], mu1 + s1 * z[1], p0, p1, ent);
      acc0 += p0;
      acc1 += p1;
      acc_e += ent;
      if (second) {
        two_class(mu0 + s0 * z[2], mu1 + s1 * z[3], p0, p1, ent);
        acc0 += p0;
        acc1 += p1;
        acc_e += ent;
      }
    }
  }
  if (live) {
    a.sum_p[idx] = acc0;
    a.sum_p[a.n + idx] = acc1;
    a.sum_ent[idx] = acc_e;
  }
}

// Any C up to kMaxC: draw by draw, the log-sum-exp softmax and entropy.
template <bool COUNTER, bool LOGVAR, typename T>
__global__ void __launch_bounds__(256)
sampled_stats_kernel(Args a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < a.n;
  const int n = live ? idx : a.n - 1;
  const int C = a.c;
  const Source src = make_source(COUNTER, n, a.m, C, a.k0, a.k1, a.D, a.H,
                                 a.W, a.rows);
  const T* mu = static_cast<const T*>(a.mu) + n * a.smu_n;
  const T* sc = static_cast<const T*>(a.scale) + n * a.ssc_n;
  float acc[kMaxC], l[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;
  float acc_e = 0.0f;
  for (int im = 0; im < a.m; ++im) {
    // mu and the scale are read again for each sample (from L1): held in
    // registers for all classes they would spill
    const T* mu_m = mu + im * a.smu_m;
    const T* sc_m = sc + im * a.ssc_m;
    int held = -1;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < a.n_samples; ++i) {
      float mx = __int_as_float(0xff800000);   // -inf
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          unsigned bits;
          if (COUNTER) {
            bits = counter_word(src, im, i, c);
          } else {
            const int j = i * C + c;
            if ((j >> 2) != held) {
              held = j >> 2;
              w = draw4<false>(src, im, held);
            }
            bits = word_of(w, j & 3);
          }
          l[c] = load_f(mu_m + c * a.smu_c)
                 + load_scale<T, LOGVAR>(sc_m + c * a.ssc_c)
                 * normal_vote(bits);
          mx = fmaxf(mx, l[c]);
        }
      }
      float se = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          l[c] -= mx;
          se += ex2_approx(kLog2e * l[c]);
        }
      }
      const float inv = rcp_approx(se), lse = kLn2 * lg2_approx(se);
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          const float p = ex2_approx(kLog2e * l[c]) * inv;
          acc[c] += p;
          acc_e -= p * (l[c] - lse);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) a.sum_p[(long long)c * a.n + idx] = acc[c];
    a.sum_ent[idx] = acc_e;
  }
}

// More than kMaxC classes: as sampled_stats_kernel, draw for draw, with
// the thread's per-class values in dynamic shared memory, class c of
// thread t at [c * blockDim.x + t] in four planes: the current sample's
// logits, the current member's mu and scale (read and exponentiated once
// a member, not once a sample), and the softmax sums, written to sum_p
// once at the end.
template <bool COUNTER, bool LOGVAR, typename T>
__global__ void __launch_bounds__(256)
sampled_stats_wide_kernel(Args a) {
  extern __shared__ float wide_smem[];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < a.n;
  const int n = live ? idx : a.n - 1;
  const int C = a.c;
  const int stride = blockDim.x;
  const int plane = C * stride;
  float* const l = wide_smem + threadIdx.x;
  float* const mu_s = l + plane;
  float* const sc_s = l + 2 * plane;
  float* const acc = l + 3 * plane;
  const Source src = make_source(COUNTER, n, a.m, C, a.k0, a.k1, a.D, a.H,
                                 a.W, a.rows);
  const T* mu = static_cast<const T*>(a.mu) + n * a.smu_n;
  const T* sc = static_cast<const T*>(a.scale) + n * a.ssc_n;
  for (int c = 0; c < C; ++c) acc[c * stride] = 0.0f;
  float acc_e = 0.0f;
  for (int im = 0; im < a.m; ++im) {
    for (int c = 0; c < C; ++c) {
      mu_s[c * stride] = load_f(mu + im * a.smu_m + c * a.smu_c);
      sc_s[c * stride] = load_scale<T, LOGVAR>(sc + im * a.ssc_m +
                                               c * a.ssc_c);
    }
    int held = -1;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < a.n_samples; ++i) {
      float mx = __int_as_float(0xff800000);   // -inf
      for (int c = 0; c < C; ++c) {
        unsigned bits;
        if (COUNTER) {
          bits = counter_word(src, im, i, c);
        } else {
          const int j = i * C + c;
          if ((j >> 2) != held) {
            held = j >> 2;
            w = draw4<false>(src, im, held);
          }
          bits = word_of(w, j & 3);
        }
        const float lc = mu_s[c * stride] + sc_s[c * stride]
                         * normal_vote(bits);
        l[c * stride] = lc;
        mx = fmaxf(mx, lc);
      }
      float se = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float lc = l[c * stride] - mx;
        l[c * stride] = lc;
        se += ex2_approx(kLog2e * lc);
      }
      const float inv = rcp_approx(se), lse = kLn2 * lg2_approx(se);
      for (int c = 0; c < C; ++c) {
        const float lc = l[c * stride];
        const float p = ex2_approx(kLog2e * lc) * inv;
        acc[c * stride] += p;
        acc_e -= p * (lc - lse);
      }
    }
  }
  if (live) {
    for (int c = 0; c < C; ++c)
      a.sum_p[(long long)c * a.n + idx] = acc[c * stride];
    a.sum_ent[idx] = acc_e;
  }
}

// The draws' bits, (N, M, n_samples, C) words, from the same device
// functions as the sampling kernels.
template <bool COUNTER>
__global__ void __launch_bounds__(256)
sample_bits_kernel(unsigned* out, int n, int m, int c, int n_samples,
                   unsigned k0, unsigned k1, int D, int H, int W, int rows) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Source src = make_source(COUNTER, idx, m, c, k0, k1, D, H, W, rows);
  const int per = n_samples * c;
  for (int im = 0; im < m; ++im) {
    unsigned* row = out + ((long long)idx * m + im) * per;
    for (int g = 0; 4 * g < per; ++g) {
      const uint4 w = draw4<COUNTER>(src, im, g);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * g + k < per) row[4 * g + k] = word_of(w, k);
    }
  }
}

template <bool COUNTER, bool LOGVAR, typename T>
int launch_typed(const Args& a, int block, cudaStream_t stream) {
  const dim3 grid((a.n + block - 1) / block);
  if (a.c == 2) {
    sampled_stats_c2_kernel<COUNTER, LOGVAR, T><<<grid, block, 0, stream>>>(a);
  } else if (a.c <= kMaxC) {
    sampled_stats_kernel<COUNTER, LOGVAR, T><<<grid, block, 0, stream>>>(a);
  } else {
    auto kernel = sampled_stats_wide_kernel<COUNTER, LOGVAR, T>;
    const int smem = 4 * block * a.c * int(sizeof(float));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return int(e);
    }
    kernel<<<grid, block, smem, stream>>>(a);
  }
  return int(cudaGetLastError());
}

template <bool COUNTER, bool LOGVAR>
int launch_logvar(const Args& a, int bf16, int block, cudaStream_t stream) {
  if (bf16) return launch_typed<COUNTER, LOGVAR, __nv_bfloat16>(a, block,
                                                                stream);
  return launch_typed<COUNTER, LOGVAR, float>(a, block, stream);
}

}  // namespace

extern "C" int sampled_stats_launch(
    int bf16, int logvar, int counter, int block, const void* mu,
    const void* scale, float* sum_p, float* sum_ent, int n, int m, int c,
    int n_samples, unsigned k0, unsigned k1, long long smu_n,
    long long smu_m, long long smu_c, long long ssc_n, long long ssc_m,
    long long ssc_c, int D, int H, int W, int rows, void* stream) {
  // above kMaxC classes the block takes 4 * block * c floats of shared
  // memory, at most the 227 KB a block may use
  if (c < 1 || block % 32 || block < 32 || block > 256 ||
      (c > kMaxC && 16LL * block * c > 232448))
    return int(cudaErrorInvalidValue);
  const Args a{mu, scale, sum_p, sum_ent, n, m, c, n_samples, k0, k1,
               smu_n, smu_m, smu_c, ssc_n, ssc_m, ssc_c, D, H, W, rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counter)
    return logvar ? launch_logvar<true, true>(a, bf16, block, s)
                  : launch_logvar<true, false>(a, bf16, block, s);
  return logvar ? launch_logvar<false, true>(a, bf16, block, s)
                : launch_logvar<false, false>(a, bf16, block, s);
}

extern "C" int sample_bits_launch(int counter, int block, unsigned* out,
                                  int n, int m, int c, int n_samples,
                                  unsigned k0, unsigned k1, int D, int H,
                                  int W, int rows, void* stream) {
  const dim3 grid((n + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counter)
    sample_bits_kernel<true><<<grid, block, 0, s>>>(out, n, m, c, n_samples,
                                                    k0, k1, D, H, W, rows);
  else
    sample_bits_kernel<false><<<grid, block, 0, s>>>(out, n, m, c, n_samples,
                                                     k0, k1, D, H, W, rows);
  return int(cudaGetLastError());
}
