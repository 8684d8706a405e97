// Fused grouped 3x3x3 convolution for Hopper (sm_90a), NDHWC.
//
// Replaces the TPU kernel values_tpu/ops/pallas/conv3d.py::_conv_kernel
// (entry conv3d_banded_packed), which runs every 3x3x3 convolution of the
// grouped ensemble UNet3D. It computes, per group g of G:
//
//   v   = prologue(concat(x[g], x2[g]))   max(x*scale - shift, (..)*slope),
//                                          rounded to the input type; voxels
//                                          outside the volume are exactly 0
//   y   = conv3x3x3_same(v, W[g]) + bias  f32 accumulation
//   sum, sumsq of y per (item, channel)   optional, pre-activation, f32
//   out = act(y) in the input type         none | leaky 0.01 | relu
//
// What bounds it on an H100: at the path's shapes the wide, shallow levels
// (64^3 and 32^3, Cin*Cout of 8*8 to 32*16 per group) move the most bytes
// per multiply-add and are memory bound against the bf16 tensor-core rate;
// the deep levels (8^3, 4^3, Cout 64-128) are bound by operations. This
// first version multiplies on the CUDA cores in f32 (exact for bf16
// operands), so it is bound by the f32 FMA rate at every level; tensor
// cores (wgmma) and TMA staging are later work.
//
// Design: one block per (item, group, 8 output channels, 4x8x8 voxel
// tile). For each chunk of input channels the block stages the haloed
// 6x10x10 input tile in shared memory, applying the prologue as it loads
// (so each voxel's prologue runs once per block, not 27 times), together
// with the chunk's 27 x Cin x 8 weights. Each thread then accumulates one
// voxel's 8 outputs in registers. The epilogue adds the bias, reduces the
// statistics across the block (warp shuffles, then shared memory) and
// adds them into the (B, G*Cout) sums with one atomicAdd per channel per
// block, so the sums are not bitwise reproducible from run to run.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (values_tpu_torch/ops/kernels/build.py); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TD = 4, TH = 8, TW = 8;             // output voxel tile
constexpr int THREADS = TD * TH * TW;             // one voxel per thread
constexpr int HD = TD + 2, HH = TH + 2, HW = TW + 2;
constexpr int HVOX = HD * HH * HW;                // haloed tile voxels
constexpr int CO = 8;                             // output channels per block
constexpr int WARPS = THREADS / 32;

enum Activation { kNone = 0, kLeaky = 1, kRelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  const void* x;      // (B, D, H, W, G*cin1)
  const void* x2;     // (B, D, H, W, G*cin2) or null
  const void* w;      // (3, 3, 3, cin1+cin2, G*cout) DHWIO
  const float* bias;  // (G*cout) or null
  const float* scale; // (B, G*cin) prologue maps, or null
  const float* shift;
  const float* slope;
  void* out;          // (B, D, H, W, G*cout)
  float* ssum;        // (B, G*cout) or null
  float* ssq;
  int B, D, H, W, G, cin1, cin2, cout, activation, tiles_h, tiles_w;
};

template <typename T, int CK>
__global__ void __launch_bounds__(THREADS)
conv3d_fused_kernel(const Params p) {
  __shared__ float s_in[CK][HVOX];
  __shared__ __align__(16) float s_w[27][CK][CO];
  __shared__ float s_red[2][WARPS][CO];

  const int cin = p.cin1 + p.cin2;
  const int n_ct = (p.cout + CO - 1) / CO;
  const int g = blockIdx.y / n_ct;
  const int ct = blockIdx.y % n_ct;
  const int b = blockIdx.z;
  int tile = blockIdx.x;
  const int tw0 = (tile % p.tiles_w) * TW;
  tile /= p.tiles_w;
  const int th0 = (tile % p.tiles_h) * TH;
  const int td0 = (tile / p.tiles_h) * TD;

  const int tid = threadIdx.x;
  const int lw = tid % TW, lh = (tid / TW) % TH, ld = tid / (TW * TH);
  const int od = td0 + ld, oh = th0 + lh, ow = tw0 + lw;
  const bool valid = od < p.D && oh < p.H && ow < p.W;

  const T* x = static_cast<const T*>(p.x);
  const T* x2 = static_cast<const T*>(p.x2);
  const T* w = static_cast<const T*>(p.w);
  const long long gcout = (long long)p.G * p.cout;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = tid; i < CK * HVOX; i += THREADS) {
      const int ck = i % CK, v = i / CK;
      const int d = td0 + v / (HH * HW) - 1;
      const int h = th0 + (v / HW) % HH - 1;
      const int ww = tw0 + v % HW - 1;
      const int c = c0 + ck;
      float val = 0.f;  // SAME padding: out-of-volume taps are exactly 0
      if (c < cin && d >= 0 && d < p.D && h >= 0 && h < p.H && ww >= 0 &&
          ww < p.W) {
        const long long vox = (((long long)b * p.D + d) * p.H + h) * p.W + ww;
        val = c < p.cin1
                  ? to_f32(x[vox * p.G * p.cin1 + g * p.cin1 + c])
                  : to_f32(x2[vox * p.G * p.cin2 + g * p.cin2 + (c - p.cin1)]);
        if (p.scale != nullptr) {
          const int m = (b * p.G + g) * cin + c;
          float u = val * p.scale[m] - p.shift[m];
          u = fmaxf(u, u * p.slope[m]);
          val = to_f32(from_f32<T>(u));
        }
      }
      s_in[ck][v] = val;
    }
    for (int i = tid; i < 27 * CK * CO; i += THREADS) {
      const int co = i % CO, ck = (i / CO) % CK, tap = i / (CO * CK);
      const int c = c0 + ck, oc = ct * CO + co;
      s_w[tap][ck][co] =
          (c < cin && oc < p.cout)
              ? to_f32(w[((long long)tap * cin + c) * gcout + g * p.cout + oc])
              : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          const int v = ((ld + kd) * HH + (lh + kh)) * HW + (lw + kw);
#pragma unroll
          for (int ck = 0; ck < CK; ++ck) {
            const float xv = s_in[ck][v];
            const float4 w0 = *reinterpret_cast<const float4*>(&s_w[tap][ck][0]);
            const float4 w1 = *reinterpret_cast<const float4*>(&s_w[tap][ck][4]);
            acc[0] = fmaf(xv, w0.x, acc[0]);
            acc[1] = fmaf(xv, w0.y, acc[1]);
            acc[2] = fmaf(xv, w0.z, acc[2]);
            acc[3] = fmaf(xv, w0.w, acc[3]);
            acc[4] = fmaf(xv, w1.x, acc[4]);
            acc[5] = fmaf(xv, w1.y, acc[5]);
            acc[6] = fmaf(xv, w1.z, acc[6]);
            acc[7] = fmaf(xv, w1.w, acc[7]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int co = 0; co < CO; ++co) {
    const int oc = ct * CO + co;
    if (p.bias != nullptr && oc < p.cout) acc[co] += p.bias[g * p.cout + oc];
  }

  if (p.ssum != nullptr) {
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      float s = valid ? acc[co] : 0.f;
      float q = s * s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
        q += __shfl_down_sync(0xffffffffu, q, off);
      }
      if (lane == 0) {
        s_red[0][warp][co] = s;
        s_red[1][warp][co] = q;
      }
    }
    __syncthreads();
    if (tid < 2 * CO) {
      const int which = tid / CO, co = tid % CO, oc = ct * CO + co;
      float total = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) total += s_red[which][wi][co];
      if (oc < p.cout) {
        float* dst = which == 0 ? p.ssum : p.ssq;
        atomicAdd(dst + (long long)b * gcout + g * p.cout + oc, total);
      }
    }
  }

  if (!valid) return;
  T* out = static_cast<T*>(p.out);
  const long long vox = (((long long)b * p.D + od) * p.H + oh) * p.W + ow;
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    const int oc = ct * CO + co;
    if (oc >= p.cout) break;
    float y = acc[co];
    if (p.activation == kLeaky) y = y > 0.f ? y : 0.01f * y;
    else if (p.activation == kRelu) y = fmaxf(y, 0.f);
    out[vox * gcout + g * p.cout + oc] = from_f32<T>(y);
  }
}

template <typename T, int CK>
void launch(const Params& p, cudaStream_t stream) {
  const int tiles_d = (p.D + TD - 1) / TD;
  dim3 grid(tiles_d * p.tiles_h * p.tiles_w, p.G * ((p.cout + CO - 1) / CO),
            p.B);
  conv3d_fused_kernel<T, CK><<<grid, THREADS, 0, stream>>>(p);
}

template <typename T>
void launch_dtype(const Params& p, cudaStream_t stream) {
  // a single input channel (the first layer) would waste 7/8 of an
  // 8-channel chunk on zeros
  if (p.cin1 + p.cin2 == 1) launch<T, 1>(p, stream);
  else launch<T, 8>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; activation: 0 none, 1 leaky, 2 relu.
// Null x2 / bias / prologue / stats pointers switch those parts off.
extern "C" int conv3d_fused_launch(
    int dtype, const void* x, const void* x2, const void* w,
    const float* bias, const float* scale, const float* shift,
    const float* slope, void* out, float* ssum, float* ssq, int B, int D,
    int H, int W, int G, int cin1, int cin2, int cout, int activation,
    void* stream) {
  Params p{x, x2, w, bias, scale, shift, slope, out, ssum, ssq,
           B, D, H, W, G, cin1, cin2, cout, activation,
           (H + TH - 1) / TH, (W + TW - 1) / TW};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_dtype<float>(p, s);
  else if (dtype == 1) launch_dtype<__nv_bfloat16>(p, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
