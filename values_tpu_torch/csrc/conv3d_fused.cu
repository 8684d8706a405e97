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
// As the TPU kernel does, it keeps the concat, the prologue, the
// statistics and the activation out of device memory. Its banded-GEMM
// layout is TPU layout and is not carried over. The wrapper
// (values_tpu_torch/ops/kernels/conv3d.py::plan) picks one of four kernels
// from the dtype and the shape alone:
//
// * bfloat16, Cin and Cout multiples of 8: an implicit GEMM per group on
//   the tensor cores, mma.sync.m16n8k16 bf16 with f32 accumulation. M =
//   voxels of a tile, N = BN of the group's output channels, K = 27 Cin in
//   the weight's own (tap, channel) row order. ldmatrix reads the A
//   fragments straight from the staged haloed tile (each lane one voxel's
//   8 channels at one tap: the im2col gather costs nothing) and the B
//   fragments, transposed, from the DHWIO rows. Both are XOR-swizzled in
//   16-byte units so that 8 consecutive voxels (or weight rows) hit 8
//   distinct bank groups; the tile's row stride is padded so that all of a
//   lane's fragment rows share one swizzle phase. The epilogue works on
//   the accumulator fragments: bias, Sum y and Sum y^2 of the rows inside
//   the volume (quad shuffles, shared memory across warps, one atomicAdd
//   per channel per block, so the sums are not bitwise reproducible),
//   activation, bf16.
//   What bounds it on an H100: the wide levels (64^3, 32^3; Cin x Cout of
//   8 x 8 to 32 x 16) do ~30 multiply-adds per byte, far below the ~295
//   the tensor cores need, and would be bound by device memory; at 8
//   output channels a block does one mma per A fragment, and the work
//   around the mma (staging, the prologue, the epilogue) sets the pace.
//   The deep levels (16^3 to 4^3, up to 128 x 128) are bound by the
//   tensor-core rate. Two kernels:
//   - conv3d_shallow_kernel (the 64^3 and 32^3 levels): persistent,
//     warp-specialized blocks with the whole weight of one (group,
//     n-tile) on chip walk over tiles. A producer lane loads each haloed
//     tile with TMA (zero outside the volume, swizzled as the fragments
//     are read), the producer warps apply the prologue, and the consumer
//     warps multiply the previous tile and store the output tile with one
//     TMA store, two tile buffers passing between them through mbarriers.
//   - conv3d_mma_kernel (the deep levels, and shapes the first does not
//     take): one tile per block; 16-byte cp.async copies stage the tile
//     and stream the weight through a ring of chunks; blocks are ordered
//     (item, tile, group, n-tile) so that the blocks that read one tile
//     run together and share it in L2. Tiles of 2x8x16, 4x8x8 or 4x4x4
//     voxels (a whole 4^3 volume per tile).
// * bfloat16, Cin = 1 (the first conv): a voxel is 2 bytes per group, too
//   narrow for ldmatrix rows and 16-byte copies, and K = 27. It runs on the
//   CUDA cores in f32 (exact products of bf16 operands): a block stages an
//   8x8x32 tile of all G groups once, and each thread computes 8 voxels
//   along D for every group and output channel, 4 channels at a time,
//   reusing each staged column and each weight read across them. (Tensor
//   cores with A fragments built from scalar loads measured no faster.)
// * float32: the first version of this kernel, on the CUDA cores in full
//   f32 (TF32 would miss the float32 checks): one block per (item, group,
//   8 output channels, 4x8x8 voxel tile), the haloed 6x10x10 tile staged
//   per chunk of input channels with the prologue applied as it loads.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (values_tpu_torch/ops/kernels/build.py); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace {

enum Activation { kNone = 0, kLeaky = 1, kRelu = 2 };
enum Kernel { kF32 = 0, kCin1 = 1, kMma = 2, kShallow = 3 };
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float activate(float y, int activation) {
  if (activation == kLeaky) return y > 0.f ? y : 0.01f * y;
  if (activation == kRelu) return fmaxf(y, 0.f);
  return y;
}

// the plain version's prologue, rounded as it rounds: a product and a
// difference, each rounded in f32 (no FMA contraction)
__device__ __forceinline__ float prologue_bf16(float v, float scale,
                                               float shift, float slope) {
  const float u = __fsub_rn(__fmul_rn(v, scale), shift);
  return __bfloat162float(__float2bfloat16_rn(fmaxf(u, __fmul_rn(u, slope))));
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
  int B, D, H, W, G, cin1, cin2, cout, activation;
  int td, th, tw, tiles_h, tiles_w, n_tiles;  // voxel tile, tile grid
  int lq, sw_mask, sw_shift;  // tensor cores: log2(cin / 8), the swizzle
  int slots;                  // shallow: persistent blocks per (group, n-tile)
};

// -- float32: CUDA cores ------------------------------------------------------

constexpr int TD = 4, TH = 8, TW = 8;             // output voxel tile
constexpr int THREADS = TD * TH * TW;             // one voxel per thread
constexpr int HD = TD + 2, HH = TH + 2, HW = TW + 2;
constexpr int HVOX = HD * HH * HW;                // haloed tile voxels
constexpr int CO = 8;                             // output channels per block
constexpr int WARPS = THREADS / 32;

template <int CK>
__global__ void __launch_bounds__(THREADS)
conv3d_f32_kernel(const Params p) {
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

  const float* x = static_cast<const float*>(p.x);
  const float* x2 = static_cast<const float*>(p.x2);
  const float* w = static_cast<const float*>(p.w);
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
        val = c < p.cin1 ? x[vox * p.G * p.cin1 + g * p.cin1 + c]
                         : x2[vox * p.G * p.cin2 + g * p.cin2 + (c - p.cin1)];
        if (p.scale != nullptr) {
          const int m = (b * p.G + g) * cin + c;
          float u = val * p.scale[m] - p.shift[m];
          val = fmaxf(u, u * p.slope[m]);
        }
      }
      s_in[ck][v] = val;
    }
    for (int i = tid; i < 27 * CK * CO; i += THREADS) {
      const int co = i % CO, ck = (i / CO) % CK, tap = i / (CO * CK);
      const int c = c0 + ck, oc = ct * CO + co;
      s_w[tap][ck][co] =
          (c < cin && oc < p.cout)
              ? w[((long long)tap * cin + c) * gcout + g * p.cout + oc]
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
  float* out = static_cast<float*>(p.out);
  const long long vox = (((long long)b * p.D + od) * p.H + oh) * p.W + ow;
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    const int oc = ct * CO + co;
    if (oc >= p.cout) break;
    out[vox * gcout + g * p.cout + oc] = activate(acc[co], p.activation);
  }
}

int launch_f32(const Params& p, cudaStream_t stream) {
  const int tiles_d = (p.D + TD - 1) / TD;
  dim3 grid(tiles_d * p.tiles_h * p.tiles_w, p.G * ((p.cout + CO - 1) / CO),
            p.B);
  // a single input channel (the first layer) would waste 7/8 of an
  // 8-channel chunk on zeros
  if (p.cin1 + p.cin2 == 1) conv3d_f32_kernel<1><<<grid, THREADS, 0, stream>>>(p);
  else conv3d_f32_kernel<8><<<grid, THREADS, 0, stream>>>(p);
  return 0;
}

// -- bfloat16: tensor cores ---------------------------------------------------

__device__ __forceinline__ __nv_bfloat162 bf16x2(unsigned u) {
  __nv_bfloat162 v;
  *reinterpret_cast<unsigned*>(&v) = u;
  return v;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned& r0,
                                          unsigned& r1, unsigned& r2,
                                          unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned& r0,
                                          unsigned& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kNStage = 3;  // weight chunks in the ring
constexpr int kChunk = 64;  // weight rows (K) per chunk

// Stored voxel index of tile row m for a haloed row stride hwd.
__host__ __device__ constexpr int stored_voxel(int m, int th, int tw, int hwd) {
  return (m / (tw * th) * (th + 2) + m / tw % th) * hwd + m % tw;
}

// The least haloed row stride >= tw + 2 for which tile rows 16 apart lie a
// multiple of 8 stored voxels apart (so one swizzle phase serves a lane's
// fragments).
constexpr int row_stride(int td, int th, int tw) {
  for (int hwd = tw + 2;; ++hwd) {
    bool ok = true;
    for (int m = 16; m < td * th * tw; ++m) {
      ok = ok && (stored_voxel(m, th, tw, hwd) -
                  stored_voxel(m % 16, th, tw, hwd)) % 8 == 0;
    }
    if (ok) return hwd;
  }
}

// A TD x TH x TW voxel tile by BN output channels. Warp layout: WN warps
// along N (1 up to BN 32), WM along M; each warp holds MI x NI fragments
// of 16 x 8. The instantiations (dispatch_mma) keep MI x NI <= 8, 32
// accumulators a thread: at 16 the 128-register budget below spills.
template <int TD_, int TH_, int TW_, int BN_>
struct MmaCfg {
  static constexpr int TD = TD_, TH = TH_, TW = TW_, BN = BN_;
  static constexpr int BM = TD * TH * TW;
  // the haloed tile: HREAL voxels, stored with the row stride HWD padded
  // so that all fragment rows of a lane share one swizzle phase
  static constexpr int HWR = TW + 2, HHT = TH + 2;
  static constexpr int HWD = row_stride(TD, TH, TW);
  static constexpr int HVOX = (TD + 2) * HHT * HWD;
  static constexpr int HREAL = (TD + 2) * HHT * HWR;
  static constexpr int WN = BN <= 32 ? 1 : 2;
  static constexpr int WM = 8 / WN < BM / 16 ? 8 / WN : BM / 16;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int MI = BM / (16 * WM);
  static constexpr int NI = BN / (8 * WN);
  static constexpr int QB = BN / 8;              // 16-byte units per row
  // swizzle of the weight rows: 8 consecutive rows, 8 bank groups
  static constexpr int W_MASK = (QB < 8 ? QB : 8) - 1;
  static constexpr int W_SHIFT = QB >= 8 ? 0 : QB == 4 ? 1 : QB == 2 ? 2 : 3;
  static_assert(MI * 16 * WM == BM && NI * 8 * WN == BN, "tile");
  static_assert(NI == 1 || NI % 2 == 0, "B fragments load in pairs");
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// A block's view of one tile: batch item, group, n-tile, tile origin.
struct TileAt {
  int b, g, nt, td0, th0, tw0;
};

template <class C>
__device__ __forceinline__ TileAt tile_at(const Params& p, int item, int g,
                                          int nt) {
  const int tile = item % p.n_tiles;
  return {item / p.n_tiles, g, nt, tile / (p.tiles_w * p.tiles_h) * C::TD,
          tile / p.tiles_w % p.tiles_h * C::TH, tile % p.tiles_w * C::TW};
}

// haloed voxel r (of HREAL) of the tile: in the volume? its flat index
// in the volume, and its index v in the stored (row-padded) tile
template <class C>
__device__ __forceinline__ bool halo_voxel(const Params& p, const TileAt& t,
                                           int r, long long& vox, int& v) {
  const int ld = r / (C::HWR * C::HHT), lh = r / C::HWR % C::HHT,
            lw = r % C::HWR;
  const int d = t.td0 + ld - 1, h = t.th0 + lh - 1, w = t.tw0 + lw - 1;
  v = (ld * C::HHT + lh) * C::HWD + lw;
  vox = (((long long)t.b * p.D + d) * p.H + h) * p.W + w;
  return d >= 0 && d < p.D && h >= 0 && h < p.H && w >= 0 && w < p.W;
}

// the staged 16-byte unit c (8 channels) of haloed voxel v, swizzled so
// that 8 consecutive voxels fall into 8 distinct bank groups
__device__ __forceinline__ int unit_index(const Params& p, int v, int c) {
  return (v << p.lq) + (c ^ ((v >> p.sw_shift) & p.sw_mask));
}

// Start the cp.async copies of a haloed tile. Each thread copies one
// 8-channel unit (THREADS is a multiple of q = 2^lq) of many voxels: x's
// block g, then x2's; zero outside the volume.
template <class C>
__device__ __forceinline__ void stage_tile(const Params& p, const TileAt& t,
                                           unsigned char* s_in) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* x2 = static_cast<const __nv_bfloat16*>(p.x2);
  const int c = threadIdx.x & ((1 << p.lq) - 1), q1 = p.cin1 >> 3;
  const __nv_bfloat16* src = c < q1 ? x + t.g * p.cin1 + c * 8
                                    : x2 + t.g * p.cin2 + (c - q1) * 8;
  const int stride = p.G * (c < q1 ? p.cin1 : p.cin2);
  for (int r = threadIdx.x >> p.lq; r < C::HREAL; r += C::THREADS >> p.lq) {
    long long vox;
    int v;
    const bool in = halo_voxel<C>(p, t, r, vox, v);
    cp_async16(smem_u32(s_in + unit_index(p, v, c) * 16),
               in ? src + vox * stride : x, in);
  }
}

// The prologue, in place on the landed tile, once per in-volume voxel
// (SAME padding stays exactly 0), by threads tid of n (n a multiple of
// q): each keeps one unit's maps. unit(v, c) points at unit c of stored
// voxel v.
template <class C, class Unit>
__device__ __forceinline__ void prologue_tile(const Params& p, const TileAt& t,
                                              Unit unit, int tid, int n) {
  const int c = tid & ((1 << p.lq) - 1), cin = 8 << p.lq;
  const int m0 = (t.b * p.G + t.g) * cin + c * 8;
  float sc[8], sh[8], sl[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = p.scale[m0 + j];
    sh[j] = p.shift[m0 + j];
    sl[j] = p.slope[m0 + j];
  }
  for (int r = tid >> p.lq; r < C::HREAL; r += n >> p.lq) {
    long long vox;
    int v;
    if (!halo_voxel<C>(p, t, r, vox, v)) continue;
    uint4* ptr = unit(v, c);
    uint4 raw = *ptr;
    unsigned* pair = reinterpret_cast<unsigned*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(bf16x2(pair[j]));
      pair[j] = pack_bf16x2(
          prologue_bf16(f.x, sc[2 * j], sh[2 * j], sl[2 * j]),
          prologue_bf16(f.y, sc[2 * j + 1], sh[2 * j + 1], sl[2 * j + 1]));
    }
    *ptr = raw;
  }
}

// Start the cp.async copies of weight rows [k0, k0 + rows) of n-tile nt
// in group g into s_w (rows x BN, swizzled); rows past 27 Cin are zero.
template <class C>
__device__ __forceinline__ void stage_weights(const Params& p, int g, int nt,
                                              int k0, int rows,
                                              __nv_bfloat16* s_w) {
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16* w_g = w + g * p.cout + nt * C::BN;
  const long long gcout = (long long)p.G * p.cout;
  const int k_rows = 27 * (p.cin1 + p.cin2);
  for (int i = threadIdx.x; i < rows * C::QB; i += C::THREADS) {
    const int r = i / C::QB, j = i % C::QB, k = k0 + r;
    const bool in = k < k_rows;
    cp_async16(smem_u32(s_w + (r * C::QB + (j ^ ((r >> C::W_SHIFT) &
                                                C::W_MASK))) * 8),
               in ? w_g + k * gcout + j * 8 : w, in);
  }
}

// Per-lane state of the K walk. A rows: voxels of the tile, as stored
// haloed indices at tap 0 (vrow0 for fragment 0; the other fragments' rows
// lie whole padded rows further, at byte offsets row_bytes, and share its
// swizzle phase). K unit: lanes 0-15 take the even 8-channel unit of a
// 16-deep step, lanes 16-31 the odd one; unit u is (tap u / q, u % q).
template <class C>
struct Walk {
  int vrow0;
  int row_bytes[C::MI];
  int tap, cc;

  // lq: log2 of the units per voxel in K; voxel_bytes: a stored voxel
  __device__ __forceinline__ Walk(int lq, int voxel_bytes, int wm, int lane) {
#pragma unroll
    for (int i = 0; i < C::MI; ++i) {
      const int m = (wm * C::MI + i) * 16 + (lane & 15);
      const int v = stored_voxel(m, C::TH, C::TW, C::HWD);
      if (i == 0) vrow0 = v;
      row_bytes[i] = (v - vrow0) * voxel_bytes;
    }
    restart(lq, lane);
  }
  __device__ __forceinline__ void restart(int lq, int lane) {
    tap = (lane >> 4) >> lq;
    cc = (lane >> 4) & ((1 << lq) - 1);
  }
};

// n_steps 16-deep steps of the GEMM: B fragments from the weight rows at
// w_base (ldmatrix.trans), A fragments straight from the haloed tile
// (ldmatrix, one voxel's 8 channels at one tap per lane): unit_addr(v, c)
// is the shared address of unit c of stored voxel v.
template <class C, int UNROLL, class UnitAddr>
__device__ __forceinline__ void mma_steps(int q, float (&acc)[C::MI][C::NI][4],
                                          Walk<C>& walk, const int* s_tap,
                                          UnitAddr unit_addr, unsigned zero_addr,
                                          unsigned w_base, int n_steps,
                                          int wn, int lane) {
#pragma unroll UNROLL
  for (int ks = 0; ks < n_steps; ++ks) {
    unsigned bf[C::NI][2];
    const int kr = ks * 16 + (lane & 15);
    const int wsw = (kr >> C::W_SHIFT) & C::W_MASK;
    if constexpr (C::NI == 1) {
      ldsm_x2_t(w_base + (kr * C::QB + ((wn * C::NI) ^ wsw)) * 16, bf[0][0],
                bf[0][1]);
    } else {
#pragma unroll
      for (int jj = 0; jj < C::NI / 2; ++jj) {
        const int j = wn * C::NI + 2 * jj + (lane >> 4);
        ldsm_x4_t(w_base + (kr * C::QB + (j ^ wsw)) * 16, bf[2 * jj][0],
                  bf[2 * jj][1], bf[2 * jj + 1][0], bf[2 * jj + 1][1]);
      }
    }
    const bool real = walk.tap < 27;  // K's zero padding reads the zero row
    const unsigned a0 =
        real ? unit_addr(walk.vrow0 + s_tap[walk.tap], walk.cc) : zero_addr;
#pragma unroll
    for (int i = 0; i < C::MI; ++i) {
      unsigned a[4];
      ldsm_x4(real ? a0 + walk.row_bytes[i] : a0, a);
#pragma unroll
      for (int j = 0; j < C::NI; ++j) mma_bf16(acc[i][j], a, bf[j][0], bf[j][1]);
    }
    walk.cc += 2;
    if (walk.cc >= q) {
      walk.cc -= q;
      ++walk.tap;
      if (walk.cc >= q) {
        walk.cc -= q;
        ++walk.tap;
      }
    }
  }
}

// The epilogue on the fragments: lane holds rows lane/4 and lane/4 + 8 of
// each 16-row fragment, columns 2 (lane % 4) and + 1 of each 8-column
// one. Adds the bias; returns the row mask (bit 2 i + r: row r of
// fragment i lies in the volume); with statistics, leaves each warp's Sum
// y and Sum y^2 over those rows in s_red (quad shuffles).
template <class C>
__device__ __forceinline__ unsigned bias_and_partial_sums(
    const Params& p, const TileAt& t, float (&acc)[C::MI][C::NI][4],
    float* s_red, int wm, int wn, int lane) {
  const int n0 = t.g * p.cout + t.nt * C::BN + wn * C::NI * 8 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < C::NI; ++j) {
    const float b0 = p.bias != nullptr ? p.bias[n0 + j * 8] : 0.f;
    const float b1 = p.bias != nullptr ? p.bias[n0 + j * 8 + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < C::MI; ++i) {
      acc[i][j][0] += b0;
      acc[i][j][1] += b1;
      acc[i][j][2] += b0;
      acc[i][j][3] += b1;
    }
  }
  unsigned ok = 0;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = (wm * C::MI + i) * 16 + (lane >> 2) + 8 * r;
      if (t.td0 + m / (C::TW * C::TH) < p.D &&
          t.th0 + m / C::TW % C::TH < p.H && t.tw0 + m % C::TW < p.W) {
        ok |= 1u << (2 * i + r);
      }
    }
  if (p.ssum == nullptr) return ok;
#pragma unroll
  for (int j = 0; j < C::NI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float y = ok >> (2 * i + r) & 1 ? acc[i][j][2 * r + e] : 0.f;
          s += y;
          sq += y * y;
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      if (lane < 4) {
        const int col = (wn * C::NI + j) * 8 + 2 * lane + e;
        s_red[wm * C::BN + col] = s;
        s_red[(C::WM + wm) * C::BN + col] = sq;
      }
    }
  return ok;
}

// After a barrier over the warps that wrote s_red: threads tid < 2 BN add
// the warps' sums and one atomicAdd per channel into the (B, G*Cout) sums
// (so they are not bitwise reproducible from run to run).
template <class C>
__device__ __forceinline__ void add_sums(const Params& p, const TileAt& t,
                                         const float* s_red, int tid) {
  if (tid >= 2 * C::BN) return;
  const int which = tid / C::BN, col = tid % C::BN;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < C::WM; ++i) total += s_red[(which * C::WM + i) * C::BN + col];
  atomicAdd((which == 0 ? p.ssum : p.ssq) +
                (long long)t.b * p.G * p.cout + t.g * p.cout + t.nt * C::BN + col,
            total);
}

// The epilogue of a block that stores its own rows: bias, statistics,
// activation, bf16 stores of the rows inside the volume. All threads call
// it (it synchronizes).
template <class C>
__device__ __forceinline__ void epilogue(const Params& p, const TileAt& t,
                                         float (&acc)[C::MI][C::NI][4],
                                         float* s_red, int wm, int wn,
                                         int lane) {
  const unsigned ok =
      bias_and_partial_sums<C>(p, t, acc, s_red, wm, wn, lane);
  if (p.ssum != nullptr) {
    __syncthreads();
    add_sums<C>(p, t, s_red, threadIdx.x);
  }
  const long long gcout = (long long)p.G * p.cout;
  const int n0 = t.g * p.cout + t.nt * C::BN + wn * C::NI * 8 + 2 * (lane & 3);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!(ok >> (2 * i + r) & 1)) continue;
      const int m = (wm * C::MI + i) * 16 + (lane >> 2) + 8 * r;
      const long long vox =
          (((long long)t.b * p.D + t.td0 + m / (C::TW * C::TH)) * p.H +
           t.th0 + m / C::TW % C::TH) * p.W + t.tw0 + m % C::TW;
      __nv_bfloat16* row = out + vox * gcout + n0;
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
            __floats2bfloat162_rn(activate(acc[i][j][2 * r], p.activation),
                                  activate(acc[i][j][2 * r + 1], p.activation));
      }
    }
}

template <class C>
__device__ __forceinline__ void zero_acc(float (&acc)[C::MI][C::NI][4]) {
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// shared memory after the weights and the tile(s): a zero row, the tap
// offsets, the statistics' cross-warp sums
template <class C>
constexpr int tail_bytes() {
  return 16 + 128 + 8 * C::WM * C::BN;
}

template <class C>
__device__ __forceinline__ void setup_tail(unsigned char* s_zero, int* s_tap) {
  if (threadIdx.x < 4) reinterpret_cast<int*>(s_zero)[threadIdx.x] = 0;
  if (threadIdx.x < 27) {
    const int t = threadIdx.x;
    s_tap[t] = ((t / 9) * C::HHT + t / 3 % 3) * C::HWD + t % 3;
  }
}

// One tile per block; the weight streams through a ring of kNStage
// chunks of kChunk rows, the next ones in flight while one is multiplied.
// Blocks are ordered (item, tile, group, n-tile), so the blocks that read
// one input tile run together and share it in L2. For the deep levels,
// where a group's weight (up to 27 x 128 x 128) does not fit on chip.
template <int TD_, int TH_, int TW_, int BN>
__global__ void __launch_bounds__(MmaCfg<TD_, TH_, TW_, BN>::THREADS,
                                  512 / MmaCfg<TD_, TH_, TW_, BN>::THREADS)
conv3d_mma_kernel(const Params p) {
  using C = MmaCfg<TD_, TH_, TW_, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int n_nt = p.cout / BN;
  const int nt = blockIdx.x % n_nt, g = blockIdx.x / n_nt % p.G;
  const TileAt t = tile_at<C>(p, blockIdx.x / n_nt / p.G, g, nt);
  const int k_rows = 27 * (p.cin1 + p.cin2);
  const int n_chunks = (k_rows + kChunk - 1) / kChunk;

  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* s_in = smem + kNStage * kChunk * BN * 2;
  unsigned char* s_zero = s_in + C::HVOX * (16 << p.lq);
  int* s_tap = reinterpret_cast<int*>(s_zero + 16);
  float* s_red = reinterpret_cast<float*>(s_tap + 32);

  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      stage_weights<C>(p, g, nt, c * kChunk, kChunk,
                       s_w + (c % kNStage) * kChunk * BN);
    }
    cp_async_commit();
  };
  stage_tile<C>(p, t, s_in);
  for (int c = 0; c < kNStage - 1; ++c) load_chunk(c);  // tile joins chunk 0
  setup_tail<C>(s_zero, s_tap);
  cp_async_wait<kNStage - 2>();
  __syncthreads();
  if (p.scale != nullptr) {
    prologue_tile<C>(p, t, [&](int v, int c) {
      return reinterpret_cast<uint4*>(s_in + unit_index(p, v, c) * 16);
    }, threadIdx.x, C::THREADS);
    __syncthreads();
  }

  Walk<C> walk(p.lq, 16 << p.lq, wm, lane);
  const unsigned in_base = smem_u32(s_in);
  auto unit_addr = [&](int v, int cc) {
    return in_base + unit_index(p, v, cc) * 16;
  };
  float acc[C::MI][C::NI][4];
  zero_acc<C>(acc);
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) {
      cp_async_wait<kNStage - 2>();  // chunk c has landed
      __syncthreads();               // and chunk c - 1 is consumed
    }
    load_chunk(c + kNStage - 1);
    mma_steps<C, kChunk / 16>(
        1 << p.lq, acc, walk, s_tap, unit_addr, smem_u32(s_zero),
        smem_u32(s_w + (c % kNStage) * kChunk * BN),
        (min(kChunk, k_rows - c * kChunk) + 15) / 16, wn, lane);
  }
  epilogue<C>(p, t, acc, s_red, wm, wn, lane);
}

template <class C>
int mma_smem_bytes(int lq) {
  return kNStage * kChunk * C::BN * 2 + C::HVOX * (16 << lq) + tail_bytes<C>();
}

template <class K>
int allow_smem(K kernel, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) configured = true;
  return static_cast<int>(err);
}

template <int TD_, int TH_, int TW_, int BN>
int launch_mma(const Params& p, cudaStream_t s) {
  using C = MmaCfg<TD_, TH_, TW_, BN>;
  const int bytes = mma_smem_bytes<C>(p.lq);
  if (bytes > kMaxSmem || C::THREADS % (1 << p.lq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  int rc = allow_smem(conv3d_mma_kernel<TD_, TH_, TW_, BN>, configured);
  if (rc != 0) return rc;
  const long long blocks = (long long)p.B * p.n_tiles * p.G * (p.cout / BN);
  conv3d_mma_kernel<TD_, TH_, TW_, BN>
      <<<static_cast<unsigned>(blocks), C::THREADS, bytes, s>>>(p);
  return 0;
}

int dispatch_mma(const Params& p, int bn, cudaStream_t s) {
#define K1_MMA(D, H, W, N) \
  if (p.td == D && p.th == H && p.tw == W && bn == N) \
    return launch_mma<D, H, W, N>(p, s);
  K1_MMA(2, 8, 16, 8) K1_MMA(2, 8, 16, 16) K1_MMA(2, 8, 16, 32)
  K1_MMA(4, 8, 8, 8) K1_MMA(4, 8, 8, 16) K1_MMA(4, 8, 8, 32)
  K1_MMA(4, 4, 4, 8) K1_MMA(4, 4, 4, 16) K1_MMA(4, 4, 4, 32)
  K1_MMA(4, 4, 4, 64)
#undef K1_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- bfloat16, wide shallow levels: TMA and warp specialization ---------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load5(unsigned dst, const CUtensorMap* map,
                                          unsigned bar, int c0, int c1, int c2,
                                          int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_store5(const CUtensorMap* map, unsigned src,
                                           int c0, int c1, int c2, int c3,
                                           int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// one tile per block: TD x 8 x 16 voxels, BN output channels; producer
// warps stage and normalize, consumer warps multiply and store
template <int TD_, int BN_>
struct ShallowCfg {
  static constexpr int TD = TD_, TH = 8, TW = 16, BN = BN_;
  static constexpr int BM = TD * TH * TW;
  static constexpr int HWR = TW + 2, HHT = TH + 2;
  static constexpr int HWD = row_stride(TD, TH, TW);
  static constexpr int HVOX = (TD + 2) * HHT * HWD;
  static constexpr int HREAL = (TD + 2) * HHT * HWR;
  static constexpr int WM = 4, WN = 1;            // consumer warps
  static constexpr int MI = BM / (16 * WM), NI = BN / 8;
  static constexpr int PRODUCERS = 128, CONSUMERS = WM * 32;
  static constexpr int THREADS = PRODUCERS + CONSUMERS;
  // two blocks an SM (128 registers a thread) at BN 8; at BN 16 a block
  // takes up to 168 registers without spilling
  static constexpr int MIN_BLOCKS = BN == 8 ? 2 : 1;
  static constexpr int QB = BN / 8;
  static constexpr int W_MASK = (QB < 8 ? QB : 8) - 1;
  static constexpr int W_SHIFT = QB >= 8 ? 0 : QB == 4 ? 1 : QB == 2 ? 2 : 3;
  static_assert(MI * NI <= 8, "32 accumulators a thread");
};

__host__ __device__ constexpr int round_up(int n, int a) {
  return (n + a - 1) / a * a;
}

// Shared memory of the shallow kernel, in bytes from a 1024-aligned base:
// the resident weight, two tile buffers (x's and x2's boxes, each 1024-
// aligned for TMA's swizzle), the output tile, the zero row, the tap
// offsets, the statistics' sums and six mbarriers.
template <class C>
struct ShallowSmem {
  int x_bytes, x2_bytes, in[2], out, zero, tap, red, bar, total;
  __host__ __device__ ShallowSmem(int q1, int q2, int k_pad) {
    x_bytes = C::HVOX * q1 * 16;
    x2_bytes = C::HVOX * q2 * 16;
    in[0] = round_up(k_pad * C::BN * 2, 1024);
    in[1] = in[0] + round_up(x_bytes, 1024) + round_up(x2_bytes, 1024);
    out = in[1] + round_up(x_bytes, 1024) + round_up(x2_bytes, 1024);
    zero = out + round_up(C::BM * C::BN * 2, 128);
    tap = zero + 16;
    red = tap + 128;
    bar = red + round_up(8 * C::WM * C::BN, 16);
    total = bar + 6 * 8 + 1024;  // + the base's alignment
  }
};

// Persistent blocks for the wide, shallow levels (64^3 and 32^3), where a
// tile's work is short beside the cost of staging it. A block keeps the
// whole weight of one (group, n-tile) on chip and walks over the tiles
// item = slot, slot + slots, ... Producer warps: one lane loads the
// haloed x and x2 boxes with TMA (zero outside the volume, swizzled as
// the A fragments are read), then all apply the prologue in place.
// Consumer warps: the GEMM, then the epilogue through shared memory and
// one TMA store per tile. Two tile buffers pass between them through
// mbarriers (full: TMA landed; ready: prologue done; empty: multiplied).
template <int TD_, int BN>
__global__ void __launch_bounds__(ShallowCfg<TD_, BN>::THREADS,
                                  ShallowCfg<TD_, BN>::MIN_BLOCKS)
conv3d_shallow_kernel(const Params p, const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tx2,
                      const __grid_constant__ CUtensorMap tout) {
  using C = ShallowCfg<TD_, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int q1 = p.cin1 >> 3, q2 = p.cin2 >> 3, q = q1 + q2;
  const int k_pad = round16(27 * (p.cin1 + p.cin2));
  const ShallowSmem<C> lay(q1, q2, k_pad);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  int* s_tap = reinterpret_cast<int*>(smem + lay.tap);
  float* s_red = reinterpret_cast<float*>(smem + lay.red);
  const unsigned base = smem_u32(smem), bars = base + lay.bar;
  auto full = [&](int b) { return bars + 8 * b; };
  auto ready = [&](int b) { return bars + 16 + 8 * b; };
  auto empty = [&](int b) { return bars + 32 + 8 * b; };

  const int n_nt = p.cout / BN;
  const int slot = blockIdx.x % p.slots, nt = blockIdx.x / p.slots % n_nt,
            g = blockIdx.x / p.slots / n_nt;
  const int total = p.B * p.n_tiles;

  // the weight (all threads), the tap offsets, the zero row, the barriers
  stage_weights<C>(p, g, nt, 0, k_pad, s_w);
  cp_async_commit();
  setup_tail<C>(smem + lay.zero, s_tap);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(full(b), 1);
      mbar_init(ready(b), C::PRODUCERS);
      mbar_init(empty(b), C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  __syncthreads();

  // unit c of stored voxel v: x's box for c < q1, else x2's; each box
  // holds ql = q1 units a voxel, swizzled as TMA swizzles ql * 16 bytes
  const int lq1 = p.lq - (q2 ? 1 : 0);
  auto unit_offset = [&](int b, int v, int c) {
    const int region = c < q1 ? lay.in[b] : lay.in[b] + round_up(lay.x_bytes, 1024);
    const int cl = c < q1 ? c : c - q1;
    return region + ((v << lq1) + (cl ^ ((v >> p.sw_shift) & p.sw_mask))) * 16;
  };

  if (threadIdx.x < C::PRODUCERS) {
    const int tid = threadIdx.x;
    const unsigned tx_bytes = (lay.x_bytes + lay.x2_bytes);
    for (int k = 0, item = slot; item < total; ++k, item += p.slots) {
      const int b = k & 1, n = k >> 1;
      if (n > 0) mbar_wait(empty(b), (n - 1) & 1);
      const TileAt t = tile_at<C>(p, item, g, nt);
      if (tid == 0) {
        mbar_expect_tx(full(b), tx_bytes);
        tma_load5(base + lay.in[b], &tx, full(b), g * p.cin1, t.tw0 - 1,
                  t.th0 - 1, t.td0 - 1, t.b);
        if (q2) {
          tma_load5(base + lay.in[b] + round_up(lay.x_bytes, 1024), &tx2,
                    full(b), g * p.cin2, t.tw0 - 1, t.th0 - 1, t.td0 - 1, t.b);
        }
      }
      mbar_wait(full(b), n & 1);
      if (p.scale != nullptr) {
        prologue_tile<C>(p, t, [&](int v, int cu) {
          return reinterpret_cast<uint4*>(smem + unit_offset(b, v, cu));
        }, tid, C::PRODUCERS);
      }
      mbar_arrive(ready(b));
    }
    return;
  }

  // consumers
  const int ctid = threadIdx.x - C::PRODUCERS, lane = ctid & 31,
            wm = ctid >> 5;
  Walk<C> walk(p.lq, 16 << lq1, wm, lane);
  const unsigned zero_addr = base + lay.zero, w_base = base;
  const int n0 = 2 * (lane & 3);
  for (int k = 0, item = slot; item < total; ++k, item += p.slots) {
    const int b = k & 1, n = k >> 1;
    const TileAt t = tile_at<C>(p, item, g, nt);
    mbar_wait(ready(b), n & 1);
    float acc[C::MI][C::NI][4];
    zero_acc<C>(acc);
    walk.restart(p.lq, lane);
    auto unit_addr = [&](int v, int cc) { return base + unit_offset(b, v, cc); };
    mma_steps<C, 1>(q, acc, walk, s_tap, unit_addr, zero_addr, w_base,
                    k_pad / 16, 0, lane);
    mbar_arrive(empty(b));

    // epilogue: bias, statistics, activation, and the tile through shared
    // memory to one TMA store (which clips the rows outside the volume)
    bias_and_partial_sums<C>(p, t, acc, s_red, wm, 0, lane);
    // the last tile's TMA store has read the output tile
    if (ctid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"r"(C::CONSUMERS) : "memory");
    if (p.ssum != nullptr) add_sums<C>(p, t, s_red, ctid);
    unsigned char* out_tile = smem + lay.out;
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = (wm * C::MI + i) * 16 + (lane >> 2) + 8 * r;
#pragma unroll
        for (int j = 0; j < C::NI; ++j) {
          *reinterpret_cast<unsigned*>(out_tile + (m * BN + j * 8 + n0) * 2) =
              pack_bf16x2(activate(acc[i][j][2 * r], p.activation),
                          activate(acc[i][j][2 * r + 1], p.activation));
        }
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"r"(C::CONSUMERS) : "memory");
    if (ctid == 0) {
      tma_store5(&tout, base + lay.out, g * p.cout + nt * BN, t.tw0,
                 t.th0, t.td0, t.b);
    }
  }
  if (ctid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A 5-D tensor map over an NDHWC tensor (B, D, H, W, channels): boxes of
// box_c channels x box_w x box_h x box_d voxels of one item, swizzled in
// shared memory over box_c * 2 bytes (16: none; 32, 64, 128) or not.
int encode_map(CUtensorMap* map, const void* ptr, const Params& p, int channels,
               int box_c, int box_w, int box_h, int box_d, bool swizzled) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return static_cast<int>(cudaErrorNotSupported);
    }
  }
  const cuuint64_t dims[5] = {(cuuint64_t)channels, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)p.D,
                              (cuuint64_t)p.B};
  const cuuint64_t row = (cuuint64_t)channels * 2;
  const cuuint64_t strides[4] = {row, row * p.W, row * p.W * p.H,
                                 row * p.W * p.H * p.D};
  const cuuint32_t box[5] = {(cuuint32_t)box_c, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, (cuuint32_t)box_d, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const int bytes = swizzled ? box_c * 2 : 0;
  const CUtensorMapSwizzle swizzle =
      bytes == 32    ? CU_TENSOR_MAP_SWIZZLE_32B
      : bytes == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
      : bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                             const_cast<void*>(ptr), dims, strides, box, ones,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int TD_, int BN>
int launch_shallow(Params p, cudaStream_t s) {
  using C = ShallowCfg<TD_, BN>;
  const int q1 = p.cin1 / 8, q2 = p.cin2 / 8;
  if ((q2 != 0 && q2 != q1) || q1 > 8 || (q1 & (q1 - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ShallowSmem<C> lay(q1, q2, round16(27 * (p.cin1 + p.cin2)));
  if (lay.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tx2, tout;
  int rc = encode_map(&tx, p.x, p, p.G * p.cin1, p.cin1, C::HWD, C::HHT,
                      C::TD + 2, true);
  if (rc == 0 && q2) {
    rc = encode_map(&tx2, p.x2, p, p.G * p.cin2, p.cin2, C::HWD, C::HHT,
                    C::TD + 2, true);
  } else {
    tx2 = tx;
  }
  if (rc == 0) {
    rc = encode_map(&tout, p.out, p, p.G * p.cout, BN, C::TW, C::TH, C::TD,
                    false);
  }
  if (rc != 0) return rc;
  static bool configured = false;
  rc = allow_smem(conv3d_shallow_kernel<TD_, BN>, configured);
  if (rc != 0) return rc;
  // as many blocks as fit the card at once, shared among (group, n-tile);
  // never more: a block that waits for a free SM would run its whole
  // share of tiles after the others
  static int sms = 0, per_sm = 0, per_sm_bytes = -1;  // for this kernel
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (per_sm_bytes != lay.total) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3d_shallow_kernel<TD_, BN>, C::THREADS, lay.total);
    per_sm_bytes = lay.total;
  }
  const int groups = p.G * (p.cout / BN), total = p.B * p.n_tiles;
  p.slots = sms * (per_sm > 0 ? per_sm : 1) / groups;
  if (p.slots < 1) p.slots = 1;
  if (p.slots > total) p.slots = total;
  // the swizzle of x's (and x2's) box, as TMA applies it
  const int m8 = q1 < 8 ? q1 : 8;
  p.sw_mask = m8 - 1;
  p.sw_shift = m8 == 8 ? 0 : m8 == 4 ? 1 : m8 == 2 ? 2 : 3;
  conv3d_shallow_kernel<TD_, BN>
      <<<p.slots * groups, C::THREADS, lay.total, s>>>(p, tx, tx2, tout);
  return 0;
}

// -- bfloat16, Cin = 1: CUDA cores --------------------------------------------

constexpr int C1_TD = 8, C1_TH = 8, C1_TW = 32;   // voxel tile
constexpr int C1_THREADS = C1_TH * C1_TW;         // a thread per (h, w)
constexpr int C1_HD = C1_TD + 2, C1_HH = C1_TH + 2, C1_HW = C1_TW + 2;
constexpr int C1_HVOX = C1_HD * C1_HH * C1_HW;
constexpr int C1_CO = 4;                          // output channels a pass

int cin1_smem_bytes(int groups, int cout) {
  return round16(groups * C1_HVOX * 2) + 27 * groups * cout * 4 +
         2 * (C1_THREADS / 32) * C1_CO * 4;
}

__global__ void __launch_bounds__(C1_THREADS, 2)
conv3d_cin1_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gc = p.G * p.cout;
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem);  // [G][HVOX]
  float* s_w = reinterpret_cast<float*>(smem + round16(p.G * C1_HVOX * 2));
  float* s_red = s_w + 27 * gc;                            // [2][8][C1_CO]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x % p.n_tiles, b = blockIdx.x / p.n_tiles;
  const int tw0 = (tile % p.tiles_w) * C1_TW;
  const int th0 = (tile / p.tiles_w % p.tiles_h) * C1_TH;
  const int td0 = tile / (p.tiles_w * p.tiles_h) * C1_TD;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);

  for (int i = tid; i < 27 * gc; i += C1_THREADS)  // DHWIO at Cin 1
    s_w[i] = __bfloat162float(w[i]);
  for (int i = tid; i < C1_HVOX * p.G; i += C1_THREADS) {
    const int g = i % p.G, v = i / p.G;
    const int d = td0 + v / (C1_HW * C1_HH) - 1,
              h = th0 + v / C1_HW % C1_HH - 1, ww = tw0 + v % C1_HW - 1;
    float val = 0.f;  // SAME padding: out-of-volume taps are exactly 0
    if (d >= 0 && d < p.D && h >= 0 && h < p.H && ww >= 0 && ww < p.W) {
      const long long vox = (((long long)b * p.D + d) * p.H + h) * p.W + ww;
      val = __bfloat162float(x[vox * p.G + g]);
      if (p.scale != nullptr) {
        const int m = b * p.G + g;
        val = prologue_bf16(val, p.scale[m], p.shift[m], p.slope[m]);
      }
    }
    s_x[g * C1_HVOX + v] = __float2bfloat16_rn(val);
  }
  __syncthreads();

  const int lw = tid % C1_TW, lh = tid / C1_TW;
  const int oh = th0 + lh, ow = tw0 + lw;
  const bool col_ok = oh < p.H && ow < p.W;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);

  for (int g = 0; g < p.G; ++g) {
    const __nv_bfloat16* xg = s_x + g * C1_HVOX;
    for (int co0 = 0; co0 < p.cout; co0 += C1_CO) {
      float acc[C1_TD][C1_CO];
#pragma unroll
      for (int dv = 0; dv < C1_TD; ++dv)
#pragma unroll
        for (int o = 0; o < C1_CO; ++o) acc[dv][o] = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float col[C1_HD];  // the column under (kh, kw), reused by kd
#pragma unroll
          for (int dd = 0; dd < C1_HD; ++dd)
            col[dd] = __bfloat162float(
                xg[(dd * C1_HH + lh + kh) * C1_HW + lw + kw]);
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
            const float* wp = s_w + ((kd * 3 + kh) * 3 + kw) * gc +
                              g * p.cout + co0;
            const float4 w4 = *reinterpret_cast<const float4*>(wp);
            const float wv[C1_CO] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int dv = 0; dv < C1_TD; ++dv)
#pragma unroll
              for (int o = 0; o < C1_CO; ++o)
                acc[dv][o] = fmaf(col[dv + kd], wv[o], acc[dv][o]);
          }
        }

      bool ok[C1_TD];
#pragma unroll
      for (int dv = 0; dv < C1_TD; ++dv) {
        ok[dv] = col_ok && td0 + dv < p.D;
#pragma unroll
        for (int o = 0; o < C1_CO; ++o)
          if (p.bias != nullptr) acc[dv][o] += p.bias[g * p.cout + co0 + o];
      }

      if (p.ssum != nullptr) {
#pragma unroll
        for (int o = 0; o < C1_CO; ++o) {
          float s = 0.f, sq = 0.f;
#pragma unroll
          for (int dv = 0; dv < C1_TD; ++dv) {
            const float y = ok[dv] ? acc[dv][o] : 0.f;
            s += y;
            sq += y * y;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
            sq += __shfl_xor_sync(0xffffffffu, sq, off);
          }
          if (lane == 0) {
            s_red[warp * C1_CO + o] = s;
            s_red[(C1_THREADS / 32 + warp) * C1_CO + o] = sq;
          }
        }
        __syncthreads();
        if (tid < 2 * C1_CO) {
          const int which = tid / C1_CO, o = tid % C1_CO;
          float total = 0.f;
#pragma unroll
          for (int wi = 0; wi < C1_THREADS / 32; ++wi)
            total += s_red[(which * (C1_THREADS / 32) + wi) * C1_CO + o];
          atomicAdd((which == 0 ? p.ssum : p.ssq) + (long long)b * gc +
                        g * p.cout + co0 + o,
                    total);
        }
        __syncthreads();  // s_red is reused by the next channel chunk
      }

#pragma unroll
      for (int dv = 0; dv < C1_TD; ++dv) {
        if (!ok[dv]) continue;
        const long long vox =
            (((long long)b * p.D + td0 + dv) * p.H + oh) * p.W + ow;
        const int a = p.activation;
        *reinterpret_cast<uint2*>(out + vox * gc + g * p.cout + co0) =
            make_uint2(pack_bf16x2(activate(acc[dv][0], a), activate(acc[dv][1], a)),
                       pack_bf16x2(activate(acc[dv][2], a), activate(acc[dv][3], a)));
      }
    }
  }
}

int launch_cin1(const Params& p, cudaStream_t stream) {
  const int bytes = cin1_smem_bytes(p.G, p.cout);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3d_cin1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  conv3d_cin1_kernel<<<p.B * p.n_tiles, C1_THREADS, bytes, stream>>>(p);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. regime (the kernel): 0 float32 (CUDA
// cores), 1 bfloat16 Cin = 1 (CUDA cores), 2 bfloat16 tensor cores with a
// td x th x tw voxel tile and bn output channels per block, 3 the shallow
// kernel (TMA, warp-specialized, persistent with the weight on chip).
// activation: 0 none, 1 leaky, 2 relu. Null x2 / bias / prologue / stats pointers
// switch those parts off. A regime that does not take the shape returns
// cudaErrorInvalidValue without launching.
extern "C" int conv3d_fused_launch(
    int dtype, int regime, int td, int th, int tw, int bn, const void* x,
    const void* x2, const void* w, const float* bias, const float* scale,
    const float* shift, const float* slope, void* out, float* ssum,
    float* ssq, int B, int D, int H, int W, int G, int cin1, int cin2,
    int cout, int activation, void* stream) {
  Params p{x, x2, w, bias, scale, shift, slope, out, ssum, ssq,
           B, D, H, W, G, cin1, cin2, cout, activation,
           td, th, tw, 0, 0, 0, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (regime == kF32 && dtype == 0) {
    p.tiles_h = ceil_div(H, TH);
    p.tiles_w = ceil_div(W, TW);
    rc = launch_f32(p, s);
  } else if (regime == kCin1 && dtype == 1 && cin1 + cin2 == 1 &&
             x2 == nullptr && cout % 8 == 0) {
    p.tiles_h = ceil_div(H, C1_TH);
    p.tiles_w = ceil_div(W, C1_TW);
    p.n_tiles = ceil_div(D, C1_TD) * p.tiles_h * p.tiles_w;
    rc = launch_cin1(p, s);
  } else if ((regime == kMma || regime == kShallow) && dtype == 1 &&
             cin1 % 8 == 0 && cin2 % 8 == 0 && cin1 + cin2 > 0 &&
             cout % bn == 0) {
    p.tiles_h = ceil_div(H, th);
    p.tiles_w = ceil_div(W, tw);
    p.n_tiles = ceil_div(D, td) * p.tiles_h * p.tiles_w;
    const int q = (cin1 + cin2) / 8;
    int lq = 0;
    while ((1 << lq) < q) ++lq;
    const int m8 = q < 8 ? q : 8;
    // the staged voxel's swizzle: 8 consecutive voxels, 8 bank groups
    p.lq = lq;
    p.sw_mask = m8 - 1;
    p.sw_shift = m8 == 8 ? 0 : m8 == 4 ? 1 : m8 == 2 ? 2 : 3;
    if ((1 << lq) != q) {
      rc = static_cast<int>(cudaErrorInvalidValue);
    } else if (regime == kMma) {
      rc = dispatch_mma(p, bn, s);
    } else if (td == 4 && th == 8 && tw == 16 && bn == 8) {
      rc = launch_shallow<4, 8>(p, s);
    } else if (td == 2 && th == 8 && tw == 16 && bn == 16) {
      rc = launch_shallow<2, 16>(p, s);
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
