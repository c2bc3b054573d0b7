// Bidirectional masked softmax attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flash_attention` / `_flash_kernel` of
// distributed_crawler_tpu/ops/attention.py (pallas_call at :155).  It computes
// the same function: BLHD q/k/v, f32 scores, a per-key padding mask and an
// optional same-segment mask (packed rows), masked probabilities set to zero,
// the row sum clamped at 1e-30 (a fully masked row comes out as zeros), the
// output in the input dtype.
//
// What bounds it on an H100 SXM (published peaks at the 700 W limit:
// 3.35 TB/s, 989 TFLOP/s dense bf16).  For E5-small at batch 256 in bf16
// (12 heads of 32):
//   - bucket 512: 1.03e11 FLOP take >= 0.10 ms; q, k, v and out are
//     4 x 100.7 MB and take >= 0.12 ms;
//   - bucket 128: 6.4e9 FLOP take >= 6.5 us; 4 x 25.2 MB take >= 30 us.
// So the work is bound by bytes, not FLOPs, at every serving bucket.  The
// card's own power limit is printed by chip_smoke.py beside every time.
//
// The design is the simple one that is right; making it fast (wgmma, TMA,
// a pipelined ring of K/V tiles, warp specialisation) is later work.
//   - One block per (batch*head, tile of query rows).  The block loops over
//     K/V tiles of kBlockK keys staged in shared memory, so each K/V byte is
//     read from device memory once per query tile, not once per query row.
//     A [block_q, L] score tile, as the TPU kernel keeps in VMEM, does not
//     fit a block's shared memory; an online softmax (running max and
//     running sum in f32) takes its place.
//   - bf16 (the serving path): four warps of 16 query rows; both products
//     on the tensor cores with mma.sync (bf16 in, f32 accumulate), the
//     softmax on the f32 score fragments in registers.  p is rounded to
//     bf16 before the PV product, as the reference casts p to v's dtype.
//   - f32 (the tiny test model): one thread per query row on the CUDA
//     cores, keys scored kChunk at a time so the running max and the
//     rescale are updated once per chunk.
//   - q, k and v are read in place from their strides (no transpose copy);
//     the padding mask and the segment ids are per-token [B, L] int32
//     vectors, folded into one tag per staged key (no [L, L] mask).
//   - Every masked key gets probability 0 explicitly: a fully masked row has
//     running max -1e30, where exp(s - m) would be 1.
//   - Any L: the last query tile and the last key tile are ragged.
//   - Launches on the caller's stream, allocates nothing, never synchronises.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;   // f32: query rows per block, one per thread
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 8;     // f32: keys scored per online-softmax update
constexpr float kNegInf = -1e30f;
constexpr int kNoKey = INT_MIN;  // tag of a masked or out-of-range key
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kBlockK % kChunk == 0, "chunks must tile a key tile");

struct Strides {
  int b, l, h;  // in elements; the head dim is contiguous
};

// ---------------------------------------------------------------------------
// f32: one thread per query row, on the CUDA cores (the tensor cores take
// no full-precision f32, and TF32 would not hold the f32 tolerance).
template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_mask,
                 const int* __restrict__ seg, float* __restrict__ out, int L,
                 int H, int n_qtiles, Strides sq, Strides sk, Strides sv,
                 float scale_log2) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];
  __shared__ int ktag[kBlockK];

  // Query tiles of one (batch, head) are neighbours in the grid, so the
  // K/V they all read stays hot in L2.
  const int qtile = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / H;
  const int h = bh % H;
  const int row = qtile * kBlockQ + threadIdx.x;
  const bool row_ok = row < L;

  const float* kb = k + (int64_t)b * sk.b + (int64_t)h * sk.h;
  const float* vb = v + (int64_t)b * sv.b + (int64_t)h * sv.h;
  const int64_t tok0 = (int64_t)b * L;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (row_ok) {
    const float* qp = q + (int64_t)b * sq.b + (int64_t)h * sq.h +
                      (int64_t)row * sq.l;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qp[d];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  // A key is allowed for this query when its tag equals the query's:
  // tag = segment id (0 without segments) for an unmasked key.
  const int qtag = (row_ok && seg != nullptr) ? seg[tok0 + row] : 0;

  float m = kNegInf;  // running max of scaled scores, base-2 domain
  float l = 0.f;      // running sum of probabilities

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    const int nk = min(kBlockK, L - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D;
      const int d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        kv = kb[(int64_t)(k0 + j) * sk.l + d];
        vv = vb[(int64_t)(k0 + j) * sv.l + d];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    for (int j = threadIdx.x; j < kBlockK; j += kBlockQ) {
      int tag = kNoKey;
      if (j < nk) {
        const int64_t t = tok0 + k0 + j;
        if (kv_mask == nullptr || kv_mask[t] != 0) {
          tag = seg != nullptr ? seg[t] : 0;
        }
      }
      ktag[j] = tag;
    }
    __syncthreads();

    for (int c = 0; c < nk; c += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        s[jj] = ktag[j] == qtag ? dot * scale_log2 : kNegInf;
        cmax = fmaxf(cmax, s[jj]);
      }
      if (cmax > m) {
        const float corr = exp2f(m - cmax);
        l *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
        m = cmax;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + jj;
        const float p = ktag[j] == qtag ? exp2f(s[jj] - m) : 0.f;
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = out + ((tok0 + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: the same tiling, with both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).  One warp owns 16 query
// rows; per K/V tile it computes S = Q K^T as 16 x kBlockK f32 fragments,
// runs the online softmax on them (row max and sum across the 4 lanes that
// share a row), rounds P to bf16 in the register layout of an A fragment,
// and accumulates O += P V.  K and V are staged row-major, two tiles deep:
// the next tile's 16-byte cp.async copies are in flight while this one is
// computed.  A K fragment is one 32-bit shared load, a V fragment one
// ldmatrix.trans; rows are padded by 8 elements so no two lanes of a load
// meet in one bank.

constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kBlockQMma = 16 * kWarpsMma;  // query rows per block
constexpr int kPad = 8;                      // bf16 elements of row padding

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..3] += A(16x16, row) * B(16x8, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed, from the rows the lanes point at.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem_row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared without passing through registers; with
// src_bytes 0 the destination is zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
struct MmaTiles {
  __nv_bfloat16 k[2][kBlockK][D + kPad];
  __nv_bfloat16 v[2][kBlockK][D + kPad];
  int tag[2][kBlockK];
};

// Stage keys [k0, k0 + kBlockK) of one (batch, head) into buffer `buf`.
// Rows past L are zero (V) and tagged kNoKey, so they add nothing.  With
// `vec` (16-byte aligned rows) the copies are asynchronous; otherwise they
// are plain element loads.
template <int D>
__device__ __forceinline__ void stage_tile(
    MmaTiles<D>& sm, int buf, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, const int* kv_mask, const int* seg,
    int64_t tok0, int k0, int L, const Strides& sk, const Strides& sv,
    bool vec) {
  const int nk = min(kBlockK, L - k0);
  if (vec) {
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreadsMma) {
      const int j = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool in = j < nk;
      const int row = in ? k0 + j : 0;  // a valid address when zero-filling
      cp_async_16(&sm.k[buf][j][c], kb + (int64_t)row * sk.l + c,
                  in ? 16 : 0);
      cp_async_16(&sm.v[buf][j][c], vb + (int64_t)row * sv.l + c,
                  in ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreadsMma) {
      const int j = i / D;
      const int d = i % D;
      const bool in = j < nk;
      sm.k[buf][j][d] = in ? kb[(int64_t)(k0 + j) * sk.l + d] : zero;
      sm.v[buf][j][d] = in ? vb[(int64_t)(k0 + j) * sv.l + d] : zero;
    }
  }
  for (int j = threadIdx.x; j < kBlockK; j += kThreadsMma) {
    int tag = kNoKey;
    if (j < nk) {
      const int64_t tk = tok0 + k0 + j;
      if (kv_mask == nullptr || kv_mask[tk] != 0) {
        tag = seg != nullptr ? seg[tk] : 0;
      }
    }
    sm.tag[buf][j] = tag;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ kv_mask,
                     const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ out, int L, int H,
                     int n_qtiles, Strides sq, Strides sk, Strides sv,
                     float scale_log2, int vec) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kSteps = D / 16;      // k-steps of Q K^T
  constexpr int kNB = kBlockK / 8;    // n-blocks of S (8 keys each)
  constexpr int kDB = D / 8;          // n-blocks of O (8 dims each)
  __shared__ __align__(16) MmaTiles<D> sm;

  const int qtile = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / H;
  const int h = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int t = lane % 4;   // fragment column pair
  const int row0 = qtile * kBlockQMma + warp * 16 + g;  // and row0 + 8
  const int64_t tok0 = (int64_t)b * L;

  const __nv_bfloat16* kb = k + (int64_t)b * sk.b + (int64_t)h * sk.h;
  const __nv_bfloat16* vb = v + (int64_t)b * sv.b + (int64_t)h * sv.h;

  stage_tile<D>(sm, 0, kb, vb, kv_mask, seg, tok0, 0, L, sk, sv, vec);
  cp_async_commit();

  // Q as A fragments, kept in registers for the whole key loop.
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const __nv_bfloat16* qb = q + (int64_t)b * sq.b + (int64_t)h * sq.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      const __nv_bfloat16* qp = qb + (int64_t)row * sq.l;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int d = 16 * s + 8 * hi + 2 * t;
          qa[s][half + 2 * hi] = row < L ? pack_raw(qp[d], qp[d + 1])
                                         : pack_raw(zero, zero);
        }
      }
    }
  }
  int qtag[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    qtag[half] = (row < L && seg != nullptr) ? seg[tok0 + row] : 0;
  }

  float o[kDB][4];
#pragma unroll
  for (int n = 0; n < kDB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max per row, base-2 domain
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums

  const int n_tiles = (L + kBlockK - 1) / kBlockK;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      stage_tile<D>(sm, buf ^ 1, kb, vb, kv_mask, seg, tok0,
                    (it + 1) * kBlockK, L, sk, sv, vec);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* tag = sm.tag[buf];

    // S = Q K^T: s[n][0,1] row g, keys 8n + 2t (+1); s[n][2,3] row g + 8.
    float s[kNB][4];
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &sm.k[buf][8 * n + g][0];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(krow + 16 * st + 2 * t);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + 16 * st + 8 + 2 * t);
        mma_bf16(s[n], qa[st], b0, b1);
      }
    }

    // Masked online softmax over this tile.
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int2 kt = *reinterpret_cast<const int2*>(&tag[8 * n + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const bool ok = ((e & 1) ? kt.y : kt.x) == qtag[half];
        s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
        tmax[half] = fmaxf(tmax[half], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tmax[half] = fmaxf(tmax[half],
                         __shfl_xor_sync(0xffffffffu, tmax[half], 1));
      tmax[half] = fmaxf(tmax[half],
                         __shfl_xor_sync(0xffffffffu, tmax[half], 2));
      const float m_new = fmaxf(m[half], tmax[half]);
      corr[half] = exp2f(m[half] - m_new);
      m[half] = m_new;
      l[half] *= corr[half];
    }
#pragma unroll
    for (int n = 0; n < kDB; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        // Masked keys are zeroed explicitly: in a fully masked row
        // s == m == -1e30 and exp2(s - m) would be 1.
        const float p = s[n][e] > kNegInf ? exp2f(s[n][e] - m[half]) : 0.f;
        l[half] += p;
        s[n][e] = p;
      }
    }

    // O += P V, P rounded to bf16 as an A fragment (16 keys per k-step).
    // ldmatrix.trans: lanes 0-15 point at keys 16kk + lane of dims
    // [8n, 8n + 8), lanes 16-31 at the same keys of [8n + 8, 8n + 16).
#pragma unroll
    for (int kk = 0; kk < kNB / 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kDB; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, &sm.v[buf][16 * kk + (lane & 15)][8 * (n + (lane >> 4))]);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int row = row0 + 8 * half;
    if (row >= L) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* op = out + ((tok0 + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kDB; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * half] / denom,
                                o[n][2 * half + 1] / denom);
    }
  }
}

template <int D>
void launch_simt_f32(const float* q, const float* k, const float* v,
                     const int* kv_mask, const int* seg, float* out, int L,
                     int H, int blocks, int n_qtiles, Strides sq, Strides sk,
                     Strides sv, float scale_log2, cudaStream_t stream) {
  flash_fwd_kernel<D><<<blocks, kBlockQ, 0, stream>>>(
      q, k, v, kv_mask, seg, out, L, H, n_qtiles, sq, sk, sv, scale_log2);
}

template <int D>
void launch_mma_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                     const __nv_bfloat16* v, const int* kv_mask,
                     const int* seg, __nv_bfloat16* out, int L, int H,
                     int blocks, int n_qtiles, Strides sq, Strides sk,
                     Strides sv, float scale_log2, cudaStream_t stream) {
  // 16-byte copies need every K/V row start 16-byte aligned.
  auto aligned = [](const void* p, const Strides& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
           st.l % 8 == 0 && st.h % 8 == 0;
  };
  const int vec = aligned(k, sk) && aligned(v, sv);
  flash_fwd_mma_kernel<D><<<blocks, kThreadsMma, 0, stream>>>(
      q, k, v, kv_mask, seg, out, L, H, n_qtiles, sq, sk, sv, scale_log2,
      vec);
}

// f32 runs the SIMT kernel, bf16 the tensor-core one.
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_mask, const int* seg, void* out, int B,
                   int L, int H, int D, Strides sq, Strides sk, Strides sv,
                   float scale, bool bf16, cudaStream_t stream) {
  if (D != 16 && D != 32 && D != 64) return cudaErrorInvalidValue;
  const int rows = bf16 ? kBlockQMma : kBlockQ;
  const int n_qtiles = (L + rows - 1) / rows;
  const long long blocks = (long long)n_qtiles * B * H;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const float sl2 = scale * kLog2e;
  const int nb = (int)blocks;
  if (bf16) {
    const auto* tq = static_cast<const __nv_bfloat16*>(q);
    const auto* tk = static_cast<const __nv_bfloat16*>(k);
    const auto* tv = static_cast<const __nv_bfloat16*>(v);
    auto* to = static_cast<__nv_bfloat16*>(out);
    if (D == 16) {
      launch_mma_bf16<16>(tq, tk, tv, kv_mask, seg, to, L, H, nb, n_qtiles,
                          sq, sk, sv, sl2, stream);
    } else if (D == 32) {
      launch_mma_bf16<32>(tq, tk, tv, kv_mask, seg, to, L, H, nb, n_qtiles,
                          sq, sk, sv, sl2, stream);
    } else {
      launch_mma_bf16<64>(tq, tk, tv, kv_mask, seg, to, L, H, nb, n_qtiles,
                          sq, sk, sv, sl2, stream);
    }
  } else {
    const auto* tq = static_cast<const float*>(q);
    const auto* tk = static_cast<const float*>(k);
    const auto* tv = static_cast<const float*>(v);
    auto* to = static_cast<float*>(out);
    if (D == 16) {
      launch_simt_f32<16>(tq, tk, tv, kv_mask, seg, to, L, H, nb, n_qtiles,
                          sq, sk, sv, sl2, stream);
    } else if (D == 32) {
      launch_simt_f32<32>(tq, tk, tv, kv_mask, seg, to, L, H, nb, n_qtiles,
                          sq, sk, sv, sl2, stream);
    } else {
      launch_simt_f32<64>(tq, tk, tv, kv_mask, seg, to, L, H, nb, n_qtiles,
                          sq, sk, sv, sl2, stream);
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  kv_mask and segment_ids are [B, L]
// int32 (contiguous) or null.  out is [B, L, H, D] contiguous.  Returns the
// cudaError_t of the launch (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* kv_mask, const void* segment_ids,
                        void* out, int batch, int seq_len, int n_heads,
                        int head_dim, int q_sb, int q_sl, int q_sh, int k_sb,
                        int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                        float scale, int dtype, void* stream) {
  if (batch <= 0 || seq_len <= 0 || n_heads <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides sq{q_sb, q_sl, q_sh};
  const Strides sk{k_sb, k_sl, k_sh};
  const Strides sv{v_sb, v_sl, v_sh};
  const int* mask = static_cast<const int*>(kv_mask);
  const int* seg = static_cast<const int*>(segment_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, mask, seg, out, batch, seq_len, n_heads,
                     head_dim, sq, sk, sv, scale, dtype == 1, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
