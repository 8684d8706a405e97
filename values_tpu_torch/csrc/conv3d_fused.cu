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
// * float32, Cin1, Cin2 and Cout multiples of 8 with Cin / 8 a power of
//   two (every conv past the first): ``tf32x3``, the tensor-core implicit
//   GEMM above in the 3xTF32 split. Each f32 operand a becomes big =
//   tf32(a) and small = tf32(a - big) (cvt.rna.tf32.f32), and each
//   product a.b is small.big + big.small + big.big, three
//   mma.sync.m16n8k8 TF32 with f32 accumulation: the dropped small.small
//   term is ~2^-22 of |a.b|, so the result keeps float32's accuracy
//   (plain TF32 keeps ~3 decimal digits and would miss the float32
//   checks). A 16-byte unit holds 4 channels, so one K step of 8 reads
//   the same two units a bf16 step of 16 does, and the A fragments come
//   from the staged tile by the same ldmatrix; the weight is staged
//   (k, n) with its rows padded so that the B fragments' scalar loads hit
//   32 distinct banks. The tensor cores truncate as they accumulate, so
//   each 64-row weight chunk's products go into a fresh partial, added
//   to the sum rounded to nearest. The staged tile is split once (its
//   big parts and rests: twice its bytes, four times a bf16 tile's); a
//   4x4x4 tile, which the 128-channel convs take, is split as it is
//   read. The cp.async kernel only (tiles 2x8x16, 4x8x8, 4x4x4; no
//   ``shallow``); a shape no tile fits runs the CUDA-core kernel below.
//   What bounds it: on paper the TF32 rate, three products each; on an
//   H100 the work around each mma.sync (A fragments of both parts from
//   shared memory, the B splits, the K walk over twice bf16's steps)
//   takes most of its time.
// * float32, other shapes (Cin = 1, the first conv): the first version of
//   this kernel, on the CUDA cores in full f32: one block per (item,
//   group, 8 output channels, 4x8x8 voxel tile), the haloed 6x10x10 tile
//   staged per chunk of input channels with the prologue applied as it
//   loads.
//
// The dx entry (conv3d_fused_dx_launch) is K1b's backward, the port of
// conv3d.py::_banded_packed_ad*'s bwd (:906-949, :1155-1167): dx of a
// forward conv is this conv of the folded cotangent with the forward's
// weight flipped in space and transposed within each group. In one
// launch, in whichever regime above takes the swapped shape:
//   - the staging folds the cotangent in float32 as the tile lands, from
//     dy and the forward's saved output y: after an activation y > 0 ? dy
//     : slope dy; after statistics dy + ds1[b,c] + 2 y ds2[b,c]; and
//     rounds it to dy's type before the product (as both packages do);
//     voxels outside the volume stay exactly 0;
//   - the block reads the forward's DHWIO weight through the flip and the
//     group transpose as it stages it, into (n, k) rows (16-byte units of
//     one tap's channels are contiguous there), and takes the B fragments
//     with a plain ldmatrix; no weight copy is made;
//   - the blocks of the first n-tile write the folded cotangent of their
//     own voxels (the dW library call reads it) and add its float32
//     per-channel sums (db) through shared memory and one atomicAdd per
//     channel per block, so db is not bitwise reproducible.
// What bounds it: as the forward of the same shape; the fold adds a read
// of y, the cotangent one write.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (values_tpu_torch/ops/kernels/build.py); the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Activation { kNone = 0, kLeaky = 1, kRelu = 2 };
enum Kernel { kF32 = 0, kCin1 = 1, kMma = 2, kShallow = 3, kTf32 = 4 };
// the dx entry's fold of the cotangent
enum Fold { kFoldNone = 0, kFoldLeaky = 1, kFoldRelu = 2, kFoldStats = 3 };
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
  int lq, sw_mask, sw_shift;  // tensor cores: log2(16-byte units a voxel),
                              // the swizzle
  int slots;                  // shallow: persistent blocks per (group, n-tile)
  // the dx entry: x is dy, w the forward's weight (3, 3, 3, cout,
  // G*cin1), read flipped and group-transposed; the fold reads y
  // (B, D, H, W, G*cin1) and ds1, ds2 (B, G*cin1) (null: zero); dyp gets
  // the folded cotangent and db its float32 per-channel sums (G*cin1),
  // each where not null
  const void* y;
  const float* ds1;
  const float* ds2;
  void* dyp;
  float* db;
  int fold;
};

// a 16-byte unit of a staged tile or weight row: EL channels
template <typename T>
struct Elem {
  static constexpr int EL = 16 / sizeof(T);
};

// the fold of one cotangent value (as both packages fold it: each
// operation rounded in float32, no FMA contraction); the caller rounds
// the result to dy's type
__device__ __forceinline__ float fold_value(int fold, float dy, float y,
                                            float s1, float s2) {
  if (fold == kFoldLeaky) return y > 0.f ? dy : __fmul_rn(0.01f, dy);
  if (fold == kFoldRelu) return y > 0.f ? dy : __fmul_rn(0.f, dy);
  if (fold == kFoldStats)
    return __fadd_rn(__fadd_rn(dy, s1), __fmul_rn(__fmul_rn(2.f, y), s2));
  return dy;
}

// -- float32: CUDA cores ------------------------------------------------------

constexpr int TD = 4, TH = 8, TW = 8;             // output voxel tile
constexpr int THREADS = TD * TH * TW;             // one voxel per thread
constexpr int HD = TD + 2, HH = TH + 2, HW = TW + 2;
constexpr int HVOX = HD * HH * HW;                // haloed tile voxels
constexpr int CO = 8;                             // output channels per block
constexpr int WARPS = THREADS / 32;

// FLIP: the dx entry (the fold as the tile is staged, the forward's
// weight read flipped, the folded cotangent and db out)
template <int CK, bool FLIP>
__global__ void __launch_bounds__(THREADS)
conv3d_f32_kernel(const Params p) {
  __shared__ float s_in[CK][HVOX];
  __shared__ __align__(16) float s_w[27][CK][CO];
  __shared__ float s_red[2][WARPS][CO];
  __shared__ float s_db[CK];

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
  // dx: the blocks of the first channel tile write the folded cotangent
  // of their own voxels and add it into db
  const bool own_out = FLIP && ct == 0;
  if (FLIP && tid < CK) s_db[tid] = 0.f;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();  // the previous chunk is fully consumed
    float db_part = 0.f;  // channel c0 + tid % CK (THREADS % CK == 0)
    for (int i = tid; i < CK * HVOX; i += THREADS) {
      const int ck = i % CK, v = i / CK;
      const int vd = v / (HH * HW), vh = (v / HW) % HH, vw = v % HW;
      const int d = td0 + vd - 1, h = th0 + vh - 1, ww = tw0 + vw - 1;
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
        if constexpr (FLIP) {
          const long long e = vox * p.G * cin + g * cin + c;
          const int m = (b * p.G + g) * cin + c;
          val = fold_value(
              p.fold, val,
              p.y != nullptr ? static_cast<const float*>(p.y)[e] : 0.f,
              p.ds1 != nullptr ? p.ds1[m] : 0.f,
              p.ds2 != nullptr ? p.ds2[m] : 0.f);
          if (own_out && vd >= 1 && vd <= TD && vh >= 1 && vh <= TH &&
              vw >= 1 && vw <= TW) {
            if (p.dyp != nullptr) static_cast<float*>(p.dyp)[e] = val;
            db_part += val;
          }
        }
      }
      s_in[ck][v] = val;
    }
    if constexpr (FLIP) {
      if (own_out && p.db != nullptr) {
#pragma unroll
        for (int off = CK; off < 32; off <<= 1)
          db_part += __shfl_xor_sync(0xffffffffu, db_part, off);
        if (tid % 32 < CK) atomicAdd(&s_db[tid % CK], db_part);
      }
    }
    for (int i = tid; i < 27 * CK * CO; i += THREADS) {
      const int co = i % CO, ck = (i / CO) % CK, tap = i / (CO * CK);
      const int c = c0 + ck, oc = ct * CO + co;
      const long long at =
          FLIP ? ((long long)(26 - tap) * p.cout + oc) * p.G * cin + g * cin + c
               : ((long long)tap * cin + c) * gcout + g * p.cout + oc;
      s_w[tap][ck][co] = (c < cin && oc < p.cout) ? w[at] : 0.f;
    }
    __syncthreads();
    if constexpr (FLIP) {
      if (own_out && p.db != nullptr && tid < CK) {
        if (c0 + tid < cin) atomicAdd(p.db + g * cin + c0 + tid, s_db[tid]);
        s_db[tid] = 0.f;  // read again only after the next chunk's barrier
      }
    }

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

template <bool FLIP>
int launch_f32(const Params& p, cudaStream_t stream) {
  const int tiles_d = (p.D + TD - 1) / TD;
  dim3 grid(tiles_d * p.tiles_h * p.tiles_w, p.G * ((p.cout + CO - 1) / CO),
            p.B);
  // a single input channel (the first layer) would waste 7/8 of an
  // 8-channel chunk on zeros
  if (p.cin1 + p.cin2 == 1) {
    conv3d_f32_kernel<1, FLIP><<<grid, THREADS, 0, stream>>>(p);
  } else {
    conv3d_f32_kernel<8, FLIP><<<grid, THREADS, 0, stream>>>(p);
  }
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

__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned& r0,
                                        unsigned& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b + c, TF32 operands (the low 13 bits of each are not read), f32
// accumulation (which the tensor cores truncate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1,
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// the 3xTF32 split of an f32 value: big = tf32(x) rounded to nearest,
// small = tf32(x - big); big + small is x to ~2^-22 of |x|
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& big,
                                           unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(x)));
  const float rest = __fsub_rn(__uint_as_float(x), __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// a 16-byte unit as EL floats, and EL floats rounded to T as a unit
template <typename T>
__device__ __forceinline__ void unit_floats(const uint4& raw,
                                            float (&f)[Elem<T>::EL]) {
  const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = __uint_as_float(w[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(bf16x2(w[j]));
      f[2 * j] = v.x;
      f[2 * j + 1] = v.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 float_unit(const float (&f)[Elem<T>::EL]) {
  if constexpr (std::is_same<T, float>::value) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
}

// the prologue of one value, rounded to the input type as the plain
// version rounds it
template <typename T>
__device__ __forceinline__ float prologue_value(float v, float scale,
                                                float shift, float slope) {
  if constexpr (std::is_same<T, float>::value) {
    const float u = __fsub_rn(__fmul_rn(v, scale), shift);
    return fmaxf(u, __fmul_rn(u, slope));
  } else {
    return prologue_bf16(v, scale, shift, slope);
  }
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
// 16-byte unit (EL channels; THREADS is a multiple of q = 2^lq) of many
// voxels: x's block g, then x2's; zero outside the volume.
template <class C, typename T>
__device__ __forceinline__ void stage_tile(const Params& p, const TileAt& t,
                                           unsigned char* s_in) {
  constexpr int EL = Elem<T>::EL;
  const T* x = static_cast<const T*>(p.x);
  const T* x2 = static_cast<const T*>(p.x2);
  const int c = threadIdx.x & ((1 << p.lq) - 1), q1 = p.cin1 / EL;
  const T* src = c < q1 ? x + t.g * p.cin1 + c * EL
                        : x2 + t.g * p.cin2 + (c - q1) * EL;
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
template <class C, typename T, class Unit>
__device__ __forceinline__ void prologue_tile(const Params& p, const TileAt& t,
                                              Unit unit, int tid, int n) {
  constexpr int EL = Elem<T>::EL;
  const int c = tid & ((1 << p.lq) - 1), cin = EL << p.lq;
  const int m0 = (t.b * p.G + t.g) * cin + c * EL;
  float sc[EL], sh[EL], sl[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j) {
    sc[j] = p.scale[m0 + j];
    sh[j] = p.shift[m0 + j];
    sl[j] = p.slope[m0 + j];
  }
  for (int r = tid >> p.lq; r < C::HREAL; r += n >> p.lq) {
    long long vox;
    int v;
    if (!halo_voxel<C>(p, t, r, vox, v)) continue;
    uint4* ptr = unit(v, c);
    float f[EL];
    unit_floats<T>(*ptr, f);
#pragma unroll
    for (int j = 0; j < EL; ++j) f[j] = prologue_value<T>(f[j], sc[j], sh[j], sl[j]);
    *ptr = float_unit<T>(f);
  }
}

// The dx entry's fold, in place on the landed tile of dy, once per
// in-volume voxel, by threads tid of n (n a multiple of q), each on one
// unit c: yunit(v, c, vox) gives the forward's output y at that unit.
// The result is rounded to T. Where own_out, the voxels of the tile
// itself (not its halo) go to dyp (if any) and add into the thread's
// per-channel sums dbp. Loads of y go out BATCH voxels at a time (y in
// device memory: several; in shared memory: 1, fewer live registers).
template <class C, typename T, int BATCH, class Unit, class YUnit>
__device__ __forceinline__ void fold_tile(const Params& p, const TileAt& t,
                                          Unit unit, YUnit yunit, int tid,
                                          int n, bool own_out,
                                          float (&dbp)[Elem<T>::EL]) {
  constexpr int EL = Elem<T>::EL;
  const int c = tid & ((1 << p.lq) - 1), cin = EL << p.lq;
  const int m0 = (t.b * p.G + t.g) * cin + c * EL;
  float s1[EL], s2[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j) {
    s1[j] = p.ds1 != nullptr ? p.ds1[m0 + j] : 0.f;
    s2[j] = p.ds2 != nullptr ? p.ds2[m0 + j] : 0.f;
  }
  T* dyp = static_cast<T*>(p.dyp);
  const int step = n >> p.lq;
  for (int r0 = tid >> p.lq; r0 < C::HREAL; r0 += BATCH * step) {
    uint4 yv[BATCH];
    long long vox[BATCH];
    int v[BATCH];
    bool in[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int r = r0 + i * step;
      in[i] = r < C::HREAL && halo_voxel<C>(p, t, r, vox[i], v[i]);
      if (in[i]) yv[i] = yunit(v[i], c, vox[i]);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      if (!in[i]) continue;
      uint4* ptr = unit(v[i], c);
      float d[EL], y[EL];
      unit_floats<T>(*ptr, d);
      unit_floats<T>(yv[i], y);
#pragma unroll
      for (int j = 0; j < EL; ++j) d[j] = fold_value(p.fold, d[j], y[j], s1[j], s2[j]);
      const uint4 folded = float_unit<T>(d);
      *ptr = folded;
      const int r = r0 + i * step;
      const int ld = r / (C::HWR * C::HHT), lh = r / C::HWR % C::HHT,
                lw = r % C::HWR;
      if (own_out && ld >= 1 && ld <= C::TD && lh >= 1 && lh <= C::TH &&
          lw >= 1 && lw <= C::TW) {
        if (dyp != nullptr) {
          *reinterpret_cast<uint4*>(dyp + vox[i] * p.G * cin + t.g * cin +
                                    c * EL) = folded;
        }
        unit_floats<T>(folded, d);
#pragma unroll
        for (int j = 0; j < EL; ++j) dbp[j] += d[j];
      }
    }
  }
}

// A warp's db partials into the block's per-channel sums s_db: lanes of
// one unit add by shuffles, then one shared atomicAdd per lane and
// channel (the whole warp calls it).
template <typename T>
__device__ __forceinline__ void db_to_shared(const Params& p, float* s_db,
                                             float (&dbp)[Elem<T>::EL],
                                             int tid) {
  constexpr int EL = Elem<T>::EL;
  const int q = 1 << p.lq;
  for (int off = q; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < EL; ++j)
      dbp[j] += __shfl_xor_sync(0xffffffffu, dbp[j], off);
  if ((tid & 31) < q) {
#pragma unroll
    for (int j = 0; j < EL; ++j)
      atomicAdd(&s_db[(tid & (q - 1)) * EL + j], dbp[j]);
  }
}

// tf32x3 keeps the split f32 tile (twice its bytes) where the tile is
// larger than 4x4x4; a 4x4x4 tile, which deep convs of up to 128
// channels take, is split as it is read
template <class C, typename T>
__host__ __device__ constexpr bool presplit() {
  return std::is_same<T, float>::value && C::BM > 64;
}

// tf32x3: `units` staged 16-byte units of the f32 tile at `base` split
// once, their TF32 big parts in place and the rests small_off bytes
// further (the padding voxels too: they are never read)
template <class C>
__device__ __forceinline__ void split_units(unsigned char* base, int units,
                                            int small_off) {
  for (int i = threadIdx.x; i < units; i += C::THREADS) {
    uint4* big = reinterpret_cast<uint4*>(base) + i;
    const uint4 raw = *big;
    uint4 b, r;
    split_tf32(raw.x, b.x, r.x);
    split_tf32(raw.y, b.y, r.y);
    split_tf32(raw.z, b.z, r.z);
    split_tf32(raw.w, b.w, r.w);
    *big = b;
    *reinterpret_cast<uint4*>(base + small_off + i * 16) = r;
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

// f32 weight rows (k, n) for tf32x3: a row of BN channels padded to RS
// words, so that the B fragments' loads (4 rows, 8 columns) hit 32
// distinct banks
template <class C>
struct F32Rows {
  static constexpr int RS = C::BN + (C::BN == 8 ? 0 : 8);
};

template <class C>
__device__ __forceinline__ void stage_weights_f32(const Params& p, int g,
                                                  int nt, int k0, int rows,
                                                  float* s_w) {
  constexpr int QB = C::BN / 4, RS = F32Rows<C>::RS;
  const float* w = static_cast<const float*>(p.w);
  const float* w_g = w + g * p.cout + nt * C::BN;
  const long long gcout = (long long)p.G * p.cout;
  const int k_rows = 27 * (p.cin1 + p.cin2);
  for (int i = threadIdx.x; i < rows * QB; i += C::THREADS) {
    const int r = i / QB, j = i % QB, k = k0 + r;
    const bool in = k < k_rows;
    cp_async16(smem_u32(s_w + r * RS + j * 4), in ? w_g + k * gcout + j * 4 : w,
               in);
  }
}

// The dx entry's weight: K rows [k0, k0 + units * EL) of n-tile nt in
// group g, read from the forward's weight (3, 3, 3, cout, G*cin)
// through the flip and the group transpose (W'[tap][c][g cout + n] =
// W[26 - tap][n][g cin + c]) and staged as (n, k): row n holds `units`
// 16-byte units of K (one tap's EL channels each, contiguous in W) and
// one of padding, so that 8 rows fall into 8 distinct bank groups. Rows
// past 27 cin are zero.
template <class C, typename T>
__device__ __forceinline__ void stage_weights_flip(const Params& p, int g,
                                                   int nt, int k0, int units,
                                                   unsigned char* s_w, int tid,
                                                   int threads) {
  constexpr int EL = Elem<T>::EL;
  const T* w = static_cast<const T*>(p.w);
  const int cin = p.cin1, k_rows = 27 * cin;
  const long long row = (long long)p.G * cin;
  for (int i = tid; i < C::BN * units; i += threads) {
    const int n = i / units, u = i % units, k = k0 + u * EL;
    const bool in = k < k_rows;
    const int tap = k / cin, c = k - tap * cin;
    cp_async16(smem_u32(s_w + (n * (units + 1) + u) * 16),
               in ? w + ((long long)(26 - tap) * p.cout + nt * C::BN + n) * row +
                        g * cin + c
                  : w,
               in);
  }
}

// bytes of one staged weight chunk of `rows` K rows
template <class C, typename T, bool FLIP>
__host__ __device__ constexpr int w_stage_bytes(int rows) {
  return FLIP ? C::BN * (rows / Elem<T>::EL + 1) * 16
         : std::is_same<T, float>::value ? rows * F32Rows<C>::RS * 4
                                         : rows * C::BN * 2;
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

// The dx entry's B fragments of K step ks: (n, k) weight rows of w_units
// 16-byte units at w_base (8 rows at one unit a matrix, lane / 8 the
// matrix: n-fragment + lane / 16, unit 2 ks + (lane / 8) % 2); the same
// for bf16 (8 k a unit) and f32 (4 k a unit)
template <class C>
__device__ __forceinline__ void flip_b_fragments(unsigned (&bf)[C::NI][2],
                                                 unsigned w_base, int w_units,
                                                 int ks, int wn, int lane) {
  const int ku = 2 * ks + ((lane >> 3) & 1);
  if constexpr (C::NI == 1) {
    ldsm_x2(w_base + ((wn * 8 + (lane & 7)) * w_units + ku) * 16, bf[0][0],
            bf[0][1]);
  } else {
#pragma unroll
    for (int jj = 0; jj < C::NI / 2; ++jj) {
      const int n = (wn * C::NI + 2 * jj + (lane >> 4)) * 8 + (lane & 7);
      unsigned r[4];
      ldsm_x4(w_base + (n * w_units + ku) * 16, r);
      bf[2 * jj][0] = r[0];
      bf[2 * jj][1] = r[1];
      bf[2 * jj + 1][0] = r[2];
      bf[2 * jj + 1][1] = r[3];
    }
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

// n_steps 16-deep steps of the bf16 GEMM: B fragments from the staged
// weight at w_base, (k, n) rows by ldmatrix.trans, or the dx entry's
// (n, k) rows of w_units 16-byte units by ldmatrix; A fragments straight
// from the haloed tile (ldmatrix, one voxel's 8 channels at one tap per
// lane): unit_addr(v, c) is the shared address of unit c of stored voxel
// v.
template <class C, bool FLIP, int UNROLL, class UnitAddr>
__device__ __forceinline__ void mma_steps(int q, float (&acc)[C::MI][C::NI][4],
                                          Walk<C>& walk, const int* s_tap,
                                          UnitAddr unit_addr, unsigned zero_addr,
                                          unsigned w_base, int w_units,
                                          int n_steps, int wn, int lane) {
#pragma unroll UNROLL
  for (int ks = 0; ks < n_steps; ++ks) {
    unsigned bf[C::NI][2];
    if constexpr (FLIP) {
      flip_b_fragments<C>(bf, w_base, w_units, ks, wn, lane);
    } else {
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

// n_steps 8-deep steps of the tf32x3 GEMM (two 16-byte units of 4
// channels, as a bf16 step's two units of 8). B fragments: f32 (k, n)
// rows by scalar loads, or the dx entry's (n, k) rows by ldmatrix, split
// as they are read; A fragments as in bf16, from the tile split as it
// was staged where presplit<C, float>() (its big parts at the unit, the
// rests small_off bytes further), else split as they are read. Each
// product is the three TF32 products of the split (the small terms
// first), accumulated by the tensor cores (which truncate) into a fresh
// partial for this chunk of steps, added to acc rounded to nearest: over
// a deep K, truncation into one long sum would bias it by more than
// float32's error.
template <class C, bool FLIP, int UNROLL>
__device__ __forceinline__ void mma_steps_tf32(
    const Params& p, float (&acc)[C::MI][C::NI][4], Walk<C>& walk,
    const int* s_tap, unsigned in_base, unsigned w_base, int w_units,
    unsigned small_off, int n_steps, int wn, int lane) {
  const int q = 1 << p.lq;
  float part[C::MI][C::NI][4];
  zero_acc<C>(part);
#pragma unroll UNROLL
  for (int ks = 0; ks < n_steps; ++ks) {
    unsigned bf[C::NI][2];
    if constexpr (FLIP) {
      flip_b_fragments<C>(bf, w_base, w_units, ks, wn, lane);
    } else {
      constexpr int RS = F32Rows<C>::RS;
      const int kr = ks * 8 + (lane & 3);
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        const int n = (wn * C::NI + j) * 8 + (lane >> 2);
        bf[j][0] = lds32(w_base + (kr * RS + n) * 4);
        bf[j][1] = lds32(w_base + ((kr + 4) * RS + n) * 4);
      }
    }
    unsigned bb[C::NI][2], bs[C::NI][2];
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) split_tf32(bf[j][e], bb[j][e], bs[j][e]);
    const unsigned a0 =
        in_base + unit_index(p, walk.vrow0 + s_tap[walk.tap], walk.cc) * 16;
#pragma unroll
    for (int i = 0; i < C::MI; ++i) {
      unsigned ab[4], as[4];
      ldsm_x4(a0 + walk.row_bytes[i], ab);
      if constexpr (presplit<C, float>()) {
        ldsm_x4(a0 + walk.row_bytes[i] + small_off, as);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(ab[e], ab[e], as[e]);
      }
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        mma_tf32(part[i][j], as, bb[j][0], bb[j][1], part[i][j]);
        mma_tf32(part[i][j], ab, bs[j][0], bs[j][1], part[i][j]);
        mma_tf32(part[i][j], ab, bb[j][0], bb[j][1], part[i][j]);
      }
    }
    walk.cc += 2;  // q >= 2 units: at most one tap a step
    if (walk.cc >= q) {
      walk.cc -= q;
      ++walk.tap;
    }
  }
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
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
// activation, stores (in T) of the rows inside the volume. All threads
// call it (it synchronizes).
template <class C, typename T>
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
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!(ok >> (2 * i + r) & 1)) continue;
      const int m = (wm * C::MI + i) * 16 + (lane >> 2) + 8 * r;
      const long long vox =
          (((long long)t.b * p.D + t.td0 + m / (C::TW * C::TH)) * p.H +
           t.th0 + m / C::TW % C::TH) * p.W + t.tw0 + m % C::TW;
      T* row = out + vox * gcout + n0;
#pragma unroll
      for (int j = 0; j < C::NI; ++j) {
        const float lo = activate(acc[i][j][2 * r], p.activation);
        const float hi = activate(acc[i][j][2 * r + 1], p.activation);
        if constexpr (std::is_same<T, float>::value) {
          *reinterpret_cast<float2*>(row + j * 8) = make_float2(lo, hi);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
              __floats2bfloat162_rn(lo, hi);
        }
      }
    }
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

// the dx entry's db sums, after the tail: one float per channel
__host__ __device__ constexpr int db_bytes(int cin) { return round16(4 * cin); }

// One tile per block; the weight streams through a ring of kNStage
// chunks of kChunk rows, the next ones in flight while one is multiplied.
// Blocks are ordered (item, tile, group, n-tile), so the blocks that read
// one input tile run together and share it in L2. For the deep levels,
// where a group's weight (up to 27 x 128 x 128) does not fit on chip. T:
// bfloat16, or float (tf32x3: its tile takes twice the bytes). FLIP: the
// dx entry (the fold of dy as the tile lands, the forward's weight read
// flipped; y read from device memory).
// f32 at BN >= 32: 32 accumulators a thread beside the split operands;
// up to one block an SM's registers
template <int TD_, int TH_, int TW_, int BN, typename T, bool FLIP>
__global__ void __launch_bounds__(
    MmaCfg<TD_, TH_, TW_, BN>::THREADS,
    std::is_same<T, float>::value && BN >= 32
        ? 1 : 512 / MmaCfg<TD_, TH_, TW_, BN>::THREADS)
conv3d_mma_kernel(const Params p) {
  using C = MmaCfg<TD_, TH_, TW_, BN>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int EL = Elem<T>::EL, KS = 2 * EL;  // K rows a step
  constexpr int W_STAGE = w_stage_bytes<C, T, FLIP>(kChunk);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int n_nt = p.cout / BN;
  const int nt = blockIdx.x % n_nt, g = blockIdx.x / n_nt % p.G;
  const TileAt t = tile_at<C>(p, blockIdx.x / n_nt / p.G, g, nt);
  const int k_rows = 27 * (p.cin1 + p.cin2);
  const int n_chunks = (k_rows + kChunk - 1) / kChunk;

  unsigned char* s_w = smem;
  unsigned char* s_in = smem + kNStage * W_STAGE;
  const int tile_bytes = C::HVOX * (16 << p.lq);
  unsigned char* s_small = s_in + tile_bytes;  // presplit: the tile's rests
  unsigned char* s_zero = s_in + (presplit<C, T>() ? 2 : 1) * tile_bytes;
  int* s_tap = reinterpret_cast<int*>(s_zero + 16);
  float* s_red = reinterpret_cast<float*>(s_tap + 32);
  float* s_db = s_red + 2 * C::WM * BN;

  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      unsigned char* dst = s_w + (c % kNStage) * W_STAGE;
      if constexpr (FLIP) {
        stage_weights_flip<C, T>(p, g, nt, c * kChunk, kChunk / EL, dst,
                                 threadIdx.x, C::THREADS);
      } else if constexpr (std::is_same<T, float>::value) {
        stage_weights_f32<C>(p, g, nt, c * kChunk, kChunk,
                             reinterpret_cast<float*>(dst));
      } else {
        stage_weights<C>(p, g, nt, c * kChunk, kChunk,
                         reinterpret_cast<__nv_bfloat16*>(dst));
      }
    }
    cp_async_commit();
  };
  stage_tile<C, T>(p, t, s_in);
  for (int c = 0; c < kNStage - 1; ++c) load_chunk(c);  // tile joins chunk 0
  setup_tail<C>(s_zero, s_tap);
  // dx: the blocks of the first n-tile write the folded cotangent of their
  // own voxels and add it into db
  const bool own_out = FLIP && nt == 0 && (p.dyp != nullptr || p.db != nullptr);
  if (FLIP) {
    for (int i = threadIdx.x; i < p.cin1; i += C::THREADS) s_db[i] = 0.f;
  }
  cp_async_wait<kNStage - 2>();
  __syncthreads();
  auto unit = [&](int v, int c) {
    return reinterpret_cast<uint4*>(s_in + unit_index(p, v, c) * 16);
  };
  if (p.scale != nullptr) {
    prologue_tile<C, T>(p, t, unit, threadIdx.x, C::THREADS);
    __syncthreads();
  }
  if constexpr (FLIP) {
    if (p.fold != kFoldNone || own_out) {
      const T* y = static_cast<const T*>(p.y);
      const long long y_row = (long long)p.G * p.cin1;
      float dbp[EL] = {};
      fold_tile<C, T, 4>(
          p, t, unit,
          [&](int, int c, long long vox) {
            return y != nullptr
                       ? __ldg(reinterpret_cast<const uint4*>(
                             y + vox * y_row + g * p.cin1 + c * EL))
                       : make_uint4(0, 0, 0, 0);
          },
          threadIdx.x, C::THREADS, own_out, dbp);
      if (own_out && p.db != nullptr) db_to_shared<T>(p, s_db, dbp, threadIdx.x);
      __syncthreads();
      if (own_out && p.db != nullptr) {
        for (int i = threadIdx.x; i < p.cin1; i += C::THREADS)
          atomicAdd(p.db + g * p.cin1 + i, s_db[i]);
      }
    }
  }

  if constexpr (presplit<C, T>()) {
    split_units<C>(s_in, C::HVOX << p.lq, tile_bytes);
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
    const unsigned w_base = smem_u32(s_w + (c % kNStage) * W_STAGE);
    const int n_steps = (min(kChunk, k_rows - c * kChunk) + KS - 1) / KS;
    if constexpr (F32) {
      // two steps at a time: unrolled further, the split operands of
      // several steps take the registers
      mma_steps_tf32<C, FLIP, 2>(p, acc, walk, s_tap, in_base, w_base,
                                 kChunk / EL + 1, tile_bytes, n_steps, wn,
                                 lane);
    } else {
      mma_steps<C, FLIP, kChunk / KS>(1 << p.lq, acc, walk, s_tap, unit_addr,
                                      smem_u32(s_zero), w_base,
                                      kChunk / EL + 1, n_steps, wn, lane);
    }
  }
  epilogue<C, T>(p, t, acc, s_red, wm, wn, lane);
}

template <class C, typename T, bool FLIP>
int mma_smem_bytes(int lq, int cin) {
  return kNStage * w_stage_bytes<C, T, FLIP>(kChunk) +
         (presplit<C, T>() ? 2 : 1) * C::HVOX * (16 << lq) +
         tail_bytes<C>() + (FLIP ? db_bytes(cin) : 0);
}

template <class K>
int allow_smem(K kernel, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) configured = true;
  return static_cast<int>(err);
}

template <int TD_, int TH_, int TW_, int BN, typename T, bool FLIP>
int launch_mma(const Params& p, cudaStream_t s) {
  using C = MmaCfg<TD_, TH_, TW_, BN>;
  const int bytes = mma_smem_bytes<C, T, FLIP>(p.lq, p.cin1);
  if (bytes > kMaxSmem || C::THREADS % (1 << p.lq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  int rc = allow_smem(conv3d_mma_kernel<TD_, TH_, TW_, BN, T, FLIP>, configured);
  if (rc != 0) return rc;
  const long long blocks = (long long)p.B * p.n_tiles * p.G * (p.cout / BN);
  conv3d_mma_kernel<TD_, TH_, TW_, BN, T, FLIP>
      <<<static_cast<unsigned>(blocks), C::THREADS, bytes, s>>>(p);
  return 0;
}

template <typename T, bool FLIP>
int dispatch_mma(const Params& p, int bn, cudaStream_t s) {
#define K1_MMA(D, H, W, N) \
  if (p.td == D && p.th == H && p.tw == W && bn == N) \
    return launch_mma<D, H, W, N, T, FLIP>(p, s);
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
  // takes up to 168 registers without spilling (the dx entry's: two
  // blocks at either BN, its second box taking the shared memory)
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
// the resident weight (w_bytes), two tile buffers (x's and the second
// box's, x2's or the dx entry's y; each 1024-aligned for TMA's swizzle),
// the output tile, the zero row, the tap offsets, the statistics' sums,
// the dx entry's db sums (db_bytes) and six mbarriers.
template <class C>
struct ShallowSmem {
  int x_bytes, x2_bytes, in[2], out, zero, tap, red, db, bar, total;
  __host__ __device__ ShallowSmem(int q1, int q2, int w_bytes, int db_size) {
    x_bytes = C::HVOX * q1 * 16;
    x2_bytes = C::HVOX * q2 * 16;
    in[0] = round_up(w_bytes, 1024);
    in[1] = in[0] + round_up(x_bytes, 1024) + round_up(x2_bytes, 1024);
    out = in[1] + round_up(x_bytes, 1024) + round_up(x2_bytes, 1024);
    zero = out + round_up(C::BM * C::BN * 2, 128);
    tap = zero + 16;
    red = tap + 128;
    db = red + round_up(8 * C::WM * C::BN, 16);
    bar = db + db_size;
    total = bar + 6 * 8 + 1024;  // + the base's alignment
  }
};

// the shallow kernel's layout for this launch: K padded to 16 rows; FLIP
// (the dx entry) stages the weight as (n, k) rows of k_pad / 8 + 1 units
// and loads y as the second box
template <class C, bool FLIP>
__host__ __device__ ShallowSmem<C> shallow_layout(const Params& p) {
  const int q1 = p.cin1 / 8, k_pad = round16(27 * (p.cin1 + p.cin2));
  if (FLIP) {
    return ShallowSmem<C>(q1, p.y != nullptr ? q1 : 0,
                          C::BN * (k_pad / 8 + 1) * 16, db_bytes(p.cin1));
  }
  return ShallowSmem<C>(q1, p.cin2 / 8, k_pad * C::BN * 2, 0);
}

// Persistent blocks for the wide, shallow levels (64^3 and 32^3), where a
// tile's work is short beside the cost of staging it. A block keeps the
// whole weight of one (group, n-tile) on chip and walks over the tiles
// item = slot, slot + slots, ... Producer warps: one lane loads the
// haloed x and x2 boxes with TMA (zero outside the volume, swizzled as
// the A fragments are read), then all apply the prologue in place.
// Consumer warps: the GEMM, then the epilogue through shared memory and
// one TMA store per tile. Two tile buffers pass between them through
// mbarriers (full: TMA landed; ready: prologue done; empty: multiplied).
// FLIP, the dx entry: the boxes are dy's and y's, the producers fold dy
// (and write the folded cotangent and db from the first n-tile's
// blocks), the weight is the forward's, staged flipped.
template <int TD_, int BN, bool FLIP>
__global__ void __launch_bounds__(ShallowCfg<TD_, BN>::THREADS,
                                  FLIP ? 2 : ShallowCfg<TD_, BN>::MIN_BLOCKS)
conv3d_shallow_kernel(const Params p, const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tx2,
                      const __grid_constant__ CUtensorMap tout) {
  using C = ShallowCfg<TD_, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int q1 = p.cin1 >> 3, q2 = p.cin2 >> 3, q = q1 + q2;
  const int k_pad = round16(27 * (p.cin1 + p.cin2));
  const ShallowSmem<C> lay = shallow_layout<C, FLIP>(p);
  const bool box2 = lay.x2_bytes != 0;  // x2's box, or the dx entry's y
  int* s_tap = reinterpret_cast<int*>(smem + lay.tap);
  float* s_red = reinterpret_cast<float*>(smem + lay.red);
  float* s_db = reinterpret_cast<float*>(smem + lay.db);
  const unsigned base = smem_u32(smem), bars = base + lay.bar;
  auto full = [&](int b) { return bars + 8 * b; };
  auto ready = [&](int b) { return bars + 16 + 8 * b; };
  auto empty = [&](int b) { return bars + 32 + 8 * b; };

  const int n_nt = p.cout / BN;
  const int slot = blockIdx.x % p.slots, nt = blockIdx.x / p.slots % n_nt,
            g = blockIdx.x / p.slots / n_nt;
  const int total = p.B * p.n_tiles;

  // the weight (all threads), the tap offsets, the zero row, the barriers
  if constexpr (FLIP) {
    stage_weights_flip<C, __nv_bfloat16>(p, g, nt, 0, k_pad / 8, smem,
                                         threadIdx.x, C::THREADS);
    for (int i = threadIdx.x; i < p.cin1; i += C::THREADS) s_db[i] = 0.f;
  } else {
    stage_weights<C>(p, g, nt, 0, k_pad,
                     reinterpret_cast<__nv_bfloat16*>(smem));
  }
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

  // unit c of stored voxel v: x's box for c < q1, else the second box;
  // each box holds ql = q1 units a voxel, swizzled as TMA swizzles ql *
  // 16 bytes
  const int lq1 = p.lq - (q2 ? 1 : 0);
  auto unit_offset = [&](int b, int v, int c) {
    const int region = c < q1 ? lay.in[b] : lay.in[b] + round_up(lay.x_bytes, 1024);
    const int cl = c < q1 ? c : c - q1;
    return region + ((v << lq1) + (cl ^ ((v >> p.sw_shift) & p.sw_mask))) * 16;
  };

  if (threadIdx.x < C::PRODUCERS) {
    const int tid = threadIdx.x;
    const unsigned tx_bytes = (lay.x_bytes + lay.x2_bytes);
    // dx: the blocks of the first n-tile write the folded cotangent of
    // their tiles' own voxels and add it into db
    const bool own_out =
        FLIP && nt == 0 && (p.dyp != nullptr || p.db != nullptr);
    float dbp[8] = {};
    for (int k = 0, item = slot; item < total; ++k, item += p.slots) {
      const int b = k & 1, n = k >> 1;
      if (n > 0) mbar_wait(empty(b), (n - 1) & 1);
      const TileAt t = tile_at<C>(p, item, g, nt);
      if (tid == 0) {
        mbar_expect_tx(full(b), tx_bytes);
        tma_load5(base + lay.in[b], &tx, full(b), g * p.cin1, t.tw0 - 1,
                  t.th0 - 1, t.td0 - 1, t.b);
        if (box2) {
          tma_load5(base + lay.in[b] + round_up(lay.x_bytes, 1024), &tx2,
                    full(b), g * (FLIP ? p.cin1 : p.cin2), t.tw0 - 1,
                    t.th0 - 1, t.td0 - 1, t.b);
        }
      }
      mbar_wait(full(b), n & 1);
      auto unit = [&](int v, int cu) {
        return reinterpret_cast<uint4*>(smem + unit_offset(b, v, cu));
      };
      if (p.scale != nullptr) {
        prologue_tile<C, __nv_bfloat16>(p, t, unit, tid, C::PRODUCERS);
      }
      if constexpr (FLIP) {
        if (p.fold != kFoldNone || own_out) {
          fold_tile<C, __nv_bfloat16, 1>(
              p, t, unit,
              [&](int v, int c, long long) {
                return box2 ? *reinterpret_cast<const uint4*>(
                                  smem + unit_offset(b, v, q1 + c))
                            : make_uint4(0, 0, 0, 0);
              },
              tid, C::PRODUCERS, own_out, dbp);
        }
      }
      mbar_arrive(ready(b));
    }
    if constexpr (FLIP) {
      if (own_out && p.db != nullptr) {
        db_to_shared<__nv_bfloat16>(p, s_db, dbp, tid);
        asm volatile("bar.sync 2, %0;\n" ::"r"(C::PRODUCERS) : "memory");
        for (int i = tid; i < p.cin1; i += C::PRODUCERS)
          atomicAdd(p.db + g * p.cin1 + i, s_db[i]);
      }
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
    mma_steps<C, FLIP, 1>(q, acc, walk, s_tap, unit_addr, zero_addr, w_base,
                          k_pad / 8 + 1, k_pad / 16, 0, lane);
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

template <int TD_, int BN, bool FLIP>
int launch_shallow(Params p, cudaStream_t s) {
  using C = ShallowCfg<TD_, BN>;
  const int q1 = p.cin1 / 8, q2 = p.cin2 / 8;
  if ((q2 != 0 && q2 != q1) || q1 > 8 || (q1 & (q1 - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ShallowSmem<C> lay = shallow_layout<C, FLIP>(p);
  if (lay.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tx2, tout;
  int rc = encode_map(&tx, p.x, p, p.G * p.cin1, p.cin1, C::HWD, C::HHT,
                      C::TD + 2, true);
  // the second box: x2's, or the dx entry's y (dy's geometry)
  const void* second = FLIP ? p.y : p.x2;
  const int c2 = FLIP ? p.cin1 : p.cin2;
  if (rc == 0 && lay.x2_bytes != 0) {
    rc = encode_map(&tx2, second, p, p.G * c2, c2, C::HWD, C::HHT, C::TD + 2,
                    true);
  } else {
    tx2 = tx;
  }
  if (rc == 0) {
    rc = encode_map(&tout, p.out, p, p.G * p.cout, BN, C::TW, C::TH, C::TD,
                    false);
  }
  if (rc != 0) return rc;
  static bool configured = false;
  rc = allow_smem(conv3d_shallow_kernel<TD_, BN, FLIP>, configured);
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
        &per_sm, conv3d_shallow_kernel<TD_, BN, FLIP>, C::THREADS, lay.total);
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
  conv3d_shallow_kernel<TD_, BN, FLIP>
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

// The tensor-core regimes (T bfloat16: kMma, kShallow; T float: kTf32):
// the tile grid and the staged voxel's swizzle (8 consecutive voxels, 8
// bank groups), then the kernel. Cin / EL 16-byte units a voxel must be
// a power of two.
template <typename T, bool FLIP>
int launch_tensor_cores(Params& p, int regime, int bn, cudaStream_t s) {
  constexpr int EL = Elem<T>::EL;
  if (p.cin1 % 8 || p.cin2 % 8 || p.cin1 + p.cin2 == 0 || bn <= 0 ||
      p.cout % bn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.tiles_h = ceil_div(p.H, p.th);
  p.tiles_w = ceil_div(p.W, p.tw);
  p.n_tiles = ceil_div(p.D, p.td) * p.tiles_h * p.tiles_w;
  const int q = (p.cin1 + p.cin2) / EL;
  int lq = 0;
  while ((1 << lq) < q) ++lq;
  if ((1 << lq) != q) return static_cast<int>(cudaErrorInvalidValue);
  const int m8 = q < 8 ? q : 8;
  p.lq = lq;
  p.sw_mask = m8 - 1;
  p.sw_shift = m8 == 8 ? 0 : m8 == 4 ? 1 : m8 == 2 ? 2 : 3;
  if (regime == kMma || regime == kTf32) return dispatch_mma<T, FLIP>(p, bn, s);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.td == 4 && p.th == 8 && p.tw == 16 && bn == 8)
      return launch_shallow<4, 8, FLIP>(p, s);
    if (p.td == 2 && p.th == 8 && p.tw == 16 && bn == 16)
      return launch_shallow<2, 16, FLIP>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. regime (the kernel): 0 float32 (CUDA
// cores), 1 bfloat16 Cin = 1 (CUDA cores), 2 bfloat16 tensor cores with a
// td x th x tw voxel tile and bn output channels per block, 3 the shallow
// kernel (TMA, warp-specialized, persistent with the weight on chip), 4
// float32 on the tensor cores (tf32x3) with a td x th x tw tile.
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
    rc = launch_f32<false>(p, s);
  } else if (regime == kCin1 && dtype == 1 && cin1 + cin2 == 1 &&
             x2 == nullptr && cout % 8 == 0) {
    p.tiles_h = ceil_div(H, C1_TH);
    p.tiles_w = ceil_div(W, C1_TW);
    p.n_tiles = ceil_div(D, C1_TD) * p.tiles_h * p.tiles_w;
    rc = launch_cin1(p, s);
  } else if ((regime == kMma || regime == kShallow) && dtype == 1) {
    rc = launch_tensor_cores<__nv_bfloat16, false>(p, regime, bn, s);
  } else if (regime == kTf32 && dtype == 0) {
    rc = launch_tensor_cores<float, false>(p, regime, bn, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// K1b's dx in one launch. dy and y (B, D, H, W, G*cin), the forward's
// weight w (3, 3, 3, cout, G*cin) in dy's type (read flipped and
// group-transposed), ds1 and ds2 (B, G*cin) float32 or null; fold: 0
// none, 1 leaky, 2 relu (y > 0 ? dy : slope dy), 3 statistics (dy + ds1
// + 2 y ds2), y null only with fold 0. Writes dx (B, D, H, W, G*cout) in
// dy's type; where not null, the folded cotangent dyp (as dy) and db
// (G*cin) float32, which must hold zeros (the sums are added atomically).
// dtype and regime as conv3d_fused_launch's (not kCin1).
extern "C" int conv3d_fused_dx_launch(
    int dtype, int regime, int td, int th, int tw, int bn, const void* dy,
    const void* y, const void* w, const float* ds1, const float* ds2,
    int fold, void* dx, void* dyp, float* db, int B, int D, int H, int W,
    int G, int cin, int cout, void* stream) {
  Params p{dy, nullptr, w, nullptr, nullptr, nullptr, nullptr, dx, nullptr,
           nullptr, B, D, H, W, G, cin, 0, cout, kNone,
           td, th, tw, 0, 0, 0, 0, 0, 0, 0,
           y, ds1, ds2, dyp, db, fold};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (fold < kFoldNone || fold > kFoldStats ||
      (fold != kFoldNone && y == nullptr)) {
    return rc;
  }
  if (regime == kF32 && dtype == 0) {
    p.tiles_h = ceil_div(H, TH);
    p.tiles_w = ceil_div(W, TW);
    rc = launch_f32<true>(p, s);
  } else if ((regime == kMma || regime == kShallow) && dtype == 1) {
    rc = launch_tensor_cores<__nv_bfloat16, true>(p, regime, bn, s);
  } else if (regime == kTf32 && dtype == 0) {
    rc = launch_tensor_cores<float, true>(p, regime, bn, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
