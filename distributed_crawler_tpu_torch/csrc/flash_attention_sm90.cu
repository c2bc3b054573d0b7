// Bidirectional masked softmax attention, forward only, bf16, for Hopper
// (sm_90a): TMA, mbarriers, a producer warp and wgmma.
//
// Replaces the Pallas kernel `flash_attention` / `_flash_kernel` of
// distributed_crawler_tpu/ops/attention.py (pallas_call at :155) for bf16
// q/k/v at head dims 32 and 64 whose layout TMA can address; the other
// inputs go to csrc/flash_attention.cu.  It computes the same function:
// f32 scores, a per-key padding mask and an optional same-segment mask
// (packed rows), masked probabilities exactly zero, the row sum clamped at
// 1e-30 (a fully masked row comes out as zeros), bf16 output.
//
// What bounds it on an H100 SXM (published peaks at 700 W: 3.35 TB/s,
// 989 TFLOP/s dense bf16, and about 3.9e12 exponentials/s in the special
// function units, the figure of the FlashAttention-3 paper, Shah et al.
// 2024).  At head dim 32 each allowed (query, key) pair costs 128
// tensor-core FLOPs and one exp2, so the exponentials, not the products,
// are the compute bound; at E5-small's buckets the bytes and the
// exponentials are of one size (bucket 512: 0.12 ms of bytes, 0.155 ms of
// exponentials at batch 256).  So the design spends nothing on keys that
// no query of a tile may see, and keeps the copies off the compute warps:
//
//   - The token axis is flat: q/k/v are [T = B*L] tokens of H heads (the
//     wrapper checks that the batch stride is L token strides).  A work
//     item is 128 consecutive query tokens of one head: at L = 32 that is
//     four whole sequences, at L = 512 a quarter of one.  Keys come from the
//     batch rows those queries belong to, in tiles of 64 keys.  A key is
//     allowed for a query when it is unmasked and has the query's batch row
//     and segment id; the (batch row, segment) pair is the tag of a token.
//   - Persistent blocks, two per SM, walk the work items; Q has two
//     buffers, so a block's next item (its Q, its keys' tags, its first
//     K/V tiles) loads while the current one is computed.
//   - Warp specialisation: warpgroups 0 and 1 are consumers of 64 query
//     rows each; warp 0 of warpgroup 2 is the producer.  Per item it loads
//     Q with TMA, then walks the candidate key tiles.  For each tile it
//     reads the keys' mask and segment ids (one coalesced load per key,
//     prefetched two tiles ahead), decides per consumer warpgroup whether
//     any key of the tile is allowed for any of its rows, and only then waits
//     for a free stage of the ring, writes the keys' tags and issues the K
//     and V TMA loads into it.  A tile that no row may see is never loaded
//     or computed: it would add p = 0 everywhere and leave every running
//     max as it was, so skipping it changes no bit of the result.  The
//     decision is exact for any mask: a bit set per (batch row, segment id)
//     present among the warpgroup's queries, and a scan of the queries for
//     segment ids outside [0, 32).
//   - A ring of kStages stages with full/empty mbarriers.  Each stage
//     carries its tile's first key token (-1 ends the stream) and which
//     consumer warpgroups compute it, and whether it is whole for them
//     (every key allowed for every row: no per-key mask); a warpgroup that
//     does not need the tile only releases the stage.
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major); O += P V is wgmma with P from registers (the accumulator
//     layout of S is the A-fragment layout) and V as an MN-major B operand.
//     Rows of one head are 64 bytes at D = 32 and 128 at D = 64: TMA writes
//     them with the 64-byte or 128-byte swizzle, and the wgmma descriptors
//     name the same swizzle.
//   - The online softmax runs on the f32 accumulator fragments: the running
//     max starts at -1e30, a masked score is -inf, so its exp2 is exactly 0
//     (ex2.approx of -inf is +0); p is rounded to bf16 before PV, as the
//     reference casts p to v's dtype.
//   - setmaxnreg moves registers from the producer warpgroup to the
//     consumers.
//   - A key tile may run past its batch row (the flat axis reads the next
//     row's tokens there) or past T (TMA fills zeros): only the tags decide
//     which keys count, never the fill.
//   - Launches on the caller's stream, allocates nothing, never synchronises.
//     The TMA tensor maps are encoded on the host per call, through the
//     driver entry point the runtime hands out (no -lcuda).

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 128;        // query rows per block
constexpr int kWgRows = 64;         // query rows per consumer warpgroup
constexpr int kBlockN = 64;         // keys per tile
constexpr int kStages = 4;          // depth of the K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;       // two consumer warpgroups + the producer's
constexpr int kProducerRegs = 32;   // setmaxnreg: 2*128*104 + 128*32 = 384*80
constexpr int kConsumerRegs = 104;
constexpr float kNegInit = -1e30f;  // the running max before any key
constexpr int kNoRow = -1;          // batch row of a key no query may see
constexpr int kPastEnd = -2;        // batch row of a query row past T
constexpr int kEncodeFailed = 100000;  // + CUresult of cuTensorMapEncodeTiled

template <int D>
struct Smem {
  // Tiles start on 1024-byte boundaries: the swizzle is a function of the
  // shared-memory address, and the wgmma descriptors assume its pattern
  // starts at the tile (base offset 0).
  alignas(1024) __nv_bfloat16 q[2][kBlockM * D];  // two work items
  alignas(1024) __nv_bfloat16 k[kStages][kBlockN * D];
  alignas(1024) __nv_bfloat16 v[kStages][kBlockN * D];
  int2 ktag[kStages][kBlockN];  // (batch row, segment id) per key
  int tile_k0[kStages];         // first key token; -1 ends the stream
  int tile_need[kStages];       // bit w: consumer warpgroup w computes it;
                                // bit 2 + w: every key is allowed for all
                                // of its rows
  int2 qtag[2][kBlockM];        // (batch row, segment id) per query row
  unsigned qbits[2][kBlockM];   // per warpgroup and batch row (from the
                                // block's first): segment ids in [0, 32)
  int qwide[2];                 // a segment id outside [0, 32) is present
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full[2];
  uint64_t q_empty[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// seconds means a protocol fault: trap, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 33)) {
      __trap();
    }
  }
}

// --- TMA -------------------------------------------------------------------
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(swizzle) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers in place around the asynchronous products, so the
// compiler neither reads an accumulator before the wait nor reuses an
// A-fragment register while the tensor cores may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[0..32) (+)= A(64x16, smem desc) * B(16x64, smem desc), both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0..16) += A(64x16, registers) * B(16x32, smem desc, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n32k16(float* d, const uint32_t* a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..32) += A(64x16, registers) * B(16x64, smem desc, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Whether a key of batch row b (rel = b - the block's first row) and
// segment id seg is allowed for some query row of consumer warpgroup w.
template <int D>
__device__ __forceinline__ bool wg_sees(const Smem<D>& sm, const int2* qtag,
                                        int w, int rel, int b, int seg) {
  if (static_cast<unsigned>(seg) < 32u) return (sm.qbits[w][rel] >> seg) & 1u;
  if (!sm.qwide[w]) return false;
  for (int i = 0; i < kWgRows; ++i) {
    const int2 t = qtag[w * kWgRows + i];
    if (t.x == b && t.y == seg) return true;
  }
  return false;
}

// The producer warp.  For each work item (128 query rows of one head) it
// loads Q into one of two buffers, then walks the item's candidate key
// tiles, and closes the item with a sentinel stage.
template <int D>
__device__ __forceinline__ void producer(Smem<D>& sm, const CUtensorMap* tq,
                                         const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         const int* __restrict__ kv_mask,
                                         const int* __restrict__ seg, int T,
                                         int L, int n_qtiles, int n_items) {
  const int lane = threadIdx.x % 32;
  constexpr int kPer = kBlockN / 32;  // keys per lane per tile
  int stage = 0, phase = 0;           // the K/V ring
  int qb = 0, qphase = 0;             // the Q buffers
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % n_qtiles) * kBlockM;
    const int h = item / n_qtiles;
    // Candidate keys: the tokens of the batch rows the queries belong to.
    const int b_lo = q0 / L;
    const int b_hi = (min(q0 + kBlockM, T) - 1) / L;
    const int key_begin = b_lo * L;
    const int key_end = (b_hi + 1) * L;
    // Each key's mask and segment id, loaded two tiles ahead of use.
    auto fetch = [&](int k0, int* vm, int* sg) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int t = k0 + lane + 32 * i;
        vm[i] = 0;
        sg[i] = 0;
        if (t < key_end) {
          vm[i] = kv_mask != nullptr ? __ldg(kv_mask + t) : 1;
          sg[i] = seg != nullptr ? __ldg(seg + t) : 0;
        }
      }
    };
    int vm_a[kPer], sg_a[kPer], vm_b[kPer], sg_b[kPer];
    fetch(key_begin, vm_a, sg_a);
    fetch(key_begin + kBlockN, vm_b, sg_b);

    mbar_wait(&sm.q_empty[qb], qphase ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full[qb], kBlockM * D * 2);
      tma_load_3d(sm.q[qb], tq, &sm.q_full[qb], 0, h, q0);
    }
    // The queries' tags, and per warpgroup the set of (batch row, segment).
    for (int i = lane; i < 2 * kBlockM; i += 32) (&sm.qbits[0][0])[i] = 0u;
    if (lane < 2) sm.qwide[lane] = 0;
    __syncwarp();
    int2* qtag = sm.qtag[qb];
#pragma unroll
    for (int r = 0; r < kBlockM / 32; ++r) {
      const int i = lane + 32 * r;
      const int t = q0 + i;
      int2 tag = make_int2(kPastEnd, 0);
      if (t < T) {
        const int b = t / L;
        const int sv = seg != nullptr ? __ldg(seg + t) : 0;
        tag = make_int2(b, sv);
        const int w = i / kWgRows;
        if (static_cast<unsigned>(sv) < 32u) {
          atomicOr(&sm.qbits[w][b - b_lo], 1u << sv);
        } else {
          sm.qwide[w] = 1;
        }
      }
      qtag[i] = tag;
    }
    __syncwarp();
    mbar_arrive(&sm.q_full[qb]);
    // A warpgroup whose 64 rows share one tag sees a tile whole when every
    // key of it is unmasked and has that tag: no per-key mask is needed.
    int2 uni[2];
    bool is_uni[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uni[w] = qtag[w * kWgRows];
      const int2 a = qtag[w * kWgRows + lane];
      const int2 c = qtag[w * kWgRows + lane + 32];
      is_uni[w] =
          __all_sync(0xffffffffu, a.x == uni[w].x && a.y == uni[w].y &&
                                      c.x == uni[w].x && c.y == uni[w].y) &&
          uni[w].x >= 0;
    }

    for (int k0 = key_begin; k0 < key_end; k0 += kBlockN) {
      int vm[kPer], sg[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        vm[i] = vm_a[i];
        sg[i] = sg_a[i];
        vm_a[i] = vm_b[i];
        sg_a[i] = sg_b[i];
      }
      if (k0 + 2 * kBlockN < key_end) fetch(k0 + 2 * kBlockN, vm_b, sg_b);
      unsigned need = 0;
      bool whole0 = true, whole1 = true;
      int2 tag[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        tag[i] = make_int2(kNoRow, 0);
        if (vm[i] != 0) {  // t < key_end, unmasked
          const int b = (k0 + lane + 32 * i) / L;
          tag[i] = make_int2(b, sg[i]);
          if (wg_sees(sm, qtag, 0, b - b_lo, b, sg[i])) need |= 1u;
          if (wg_sees(sm, qtag, 1, b - b_lo, b, sg[i])) need |= 2u;
        }
        whole0 = whole0 && is_uni[0] && tag[i].x == uni[0].x &&
                 tag[i].y == uni[0].y;
        whole1 = whole1 && is_uni[1] && tag[i].x == uni[1].x &&
                 tag[i].y == uni[1].y;
      }
      need = __reduce_or_sync(0xffffffffu, need);
      if (need == 0) continue;  // no row may see a key of this tile
      // Bits 2 and 3: warpgroup 0 / 1 sees every key of the tile.
      need |= (__all_sync(0xffffffffu, whole0) ? 4u : 0u) |
              (__all_sync(0xffffffffu, whole1) ? 8u : 0u);
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[stage], 2 * kBlockN * D * 2);
        tma_load_3d(sm.k[stage], tk, &sm.full[stage], 0, h, k0);
        tma_load_3d(sm.v[stage], tv, &sm.full[stage], 0, h, k0);
        sm.tile_k0[stage] = k0;
        sm.tile_need[stage] = static_cast<int>(need);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) sm.ktag[stage][lane + 32 * i] = tag[i];
      mbar_arrive(&sm.full[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // The item's end.
    mbar_wait(&sm.empty[stage], phase ^ 1);
    if (lane == 0) sm.tile_k0[stage] = -1;
    mbar_arrive(&sm.full[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    if (++qb == 2) {
      qb = 0;
      qphase ^= 1;
    }
  }
}

// A consumer warpgroup: 64 query rows of each work item.
template <int D>
__device__ __forceinline__ void consumer(Smem<D>& sm,
                                         __nv_bfloat16* __restrict__ out,
                                         int T, int H, int n_qtiles,
                                         int n_items, float scale_log2) {
  constexpr int kSw = D == 32 ? 2 : 1;   // descriptor swizzle: 64 B / 128 B
  constexpr uint32_t kRowBytes = D * 2;
  constexpr uint32_t kGroup = 8 * kRowBytes;  // 8 rows: one swizzle atom
  constexpr int kNO = D / 2;                  // O accumulator registers
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int c = 2 * (lane % 4);                    // first of 2 columns
  const float neg_inf = __int_as_float(0xff800000);  // -inf
  const int r0 = wg * kWgRows + warp * 16 + lane / 4;  // and r0 + 8

  int stage = 0, phase = 0;
  int qb = 0, qphase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % n_qtiles) * kBlockM;
    const int h = item / n_qtiles;
    mbar_wait(&sm.q_full[qb], qphase);
    const int2 qt0 = sm.qtag[qb][r0];
    const int2 qt1 = sm.qtag[qb][r0 + 8];
    const uint64_t qdesc =
        make_desc(sm.q[qb] + wg * kWgRows * D, 16, kGroup, kSw);

    float o[kNO];
#pragma unroll
    for (int i = 0; i < kNO; ++i) o[i] = 0.f;
    float m0 = kNegInit, m1 = kNegInit;  // running max, scaled log2 domain
    float l0 = 0.f, l1 = 0.f;            // this thread's part of the row sums

    for (;;) {
      mbar_wait(&sm.full[stage], phase);
      const int k0 = sm.tile_k0[stage];
      const int flags = sm.tile_need[stage] >> wg;
      if (k0 >= 0 && (flags & 1)) {
        // S = Q K^T: s[4n + e] is row r0 (e < 2) or r0 + 8, key
        // 8n + c + (e & 1).  The first product overwrites s (scale-d 0).
        float s[32];
        const uint64_t kdesc = make_desc(sm.k[stage], 16, kGroup, kSw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss_m64n64k16(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);  // +32 B
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(s);

        // Scale into the log2 domain, mask by tags unless the tile is
        // whole for this warpgroup, row max over the tile.
        if (flags & 4) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int4 kt =
                *reinterpret_cast<const int4*>(&sm.ktag[stage][8 * n + c]);
            const bool a00 = kt.x == qt0.x && kt.y == qt0.y;
            const bool a01 = kt.z == qt0.x && kt.w == qt0.y;
            const bool a10 = kt.x == qt1.x && kt.y == qt1.y;
            const bool a11 = kt.z == qt1.x && kt.w == qt1.y;
            s[4 * n + 0] = a00 ? s[4 * n + 0] * scale_log2 : neg_inf;
            s[4 * n + 1] = a01 ? s[4 * n + 1] * scale_log2 : neg_inf;
            s[4 * n + 2] = a10 ? s[4 * n + 2] * scale_log2 : neg_inf;
            s[4 * n + 3] = a11 ? s[4 * n + 3] * scale_log2 : neg_inf;
          }
        }
        float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * n + 0], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= corr0;
        l1 *= corr1;
#pragma unroll
        for (int n = 0; n < kNO / 4; ++n) {
          o[4 * n + 0] *= corr0;
          o[4 * n + 1] *= corr0;
          o[4 * n + 2] *= corr1;
          o[4 * n + 3] *= corr1;
        }
        // p = exp2(s - m); a masked key's -inf gives exactly 0.
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[4 * n + 0] = ex2(s[4 * n + 0] - m0);
          s[4 * n + 1] = ex2(s[4 * n + 1] - m0);
          s[4 * n + 2] = ex2(s[4 * n + 2] - m1);
          s[4 * n + 3] = ex2(s[4 * n + 3] - m1);
          l0 += s[4 * n + 0] + s[4 * n + 1];
          l1 += s[4 * n + 2] + s[4 * n + 3];
        }
        // P in bf16 as wgmma A fragments, one per 16 keys.
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        // O += P V; V is [keys][D], D contiguous: an MN-major B operand.
        const uint64_t vdesc = make_desc(sm.v[stage], kGroup, kGroup, kSw);
        fence_regs<kNO>(o);
        fence_regs<16>(&pa[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t step = (16u * kRowBytes * kk) >> 4;  // 16 keys
          if constexpr (D == 32) {
            wgmma_rs_m64n32k16(o, pa[kk], vdesc + step);
          } else {
            wgmma_rs_m64n64k16(o, pa[kk], vdesc + step);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<kNO>(o);
        fence_regs<16>(&pa[0][0]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (k0 < 0) break;
    }
    // Q and its tags are read no more: the producer may load the next
    // item but one into this buffer while the output is written.
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.q_empty[qb]);
    if (++qb == 2) {
      qb = 0;
      qphase ^= 1;
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = q0 + r0 + 8 * half;
      if (t >= T) continue;
      const float inv = half ? inv1 : inv0;
      __nv_bfloat16* op = out + (static_cast<int64_t>(t) * H + h) * D + c;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * half] * inv,
                                  o[4 * n + 2 * half + 1] * inv);
      }
    }
  }
}

// Persistent: each block walks work items blockIdx.x, + gridDim.x, ...;
// item i is query tile i % n_qtiles of head i / n_qtiles, so the blocks
// running at one time share their heads' K/V in L2.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const int* __restrict__ kv_mask,
                      const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ out, int T, int L, int H,
                      int n_qtiles, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + pad);
  const int n_items = n_qtiles * H;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 32);               // the producer warp's lanes
      mbar_init(&sm.empty[i], kConsumerWarps);  // one lane per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 32);
      mbar_init(&sm.q_empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x / 32 == 2 * 4) {
      producer<D>(sm, &tq, &tk, &tv, kv_mask, seg, T, L, n_qtiles, n_items);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consumer<D>(sm, out, T, H, n_qtiles, n_items, scale_log2);
  }
}

// --- host --------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// One head's rows of a [T, H, D] view (token stride sl, head stride sh, in
// elements), `rows` tokens per box.
CUresult encode_map(EncodeTiled fn, CUtensorMap* map, const void* base, int T,
                    int H, int D, int sl, int sh, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sl) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), 1u,
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* kv_mask,
           const int* seg, void* out, int T, int L, int H, int q_sl, int q_sh,
           int k_sl, int k_sh, int v_sl, int v_sh, float scale_log2,
           cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed;
  CUtensorMap tq, tk, tv;
  CUresult r = encode_map(fn, &tq, q, T, H, D, q_sl, q_sh, kBlockM);
  if (r == CUDA_SUCCESS) {
    r = encode_map(fn, &tk, k, T, H, D, k_sl, k_sh, kBlockN);
  }
  if (r == CUDA_SUCCESS) {
    r = encode_map(fn, &tv, v, T, H, D, v_sl, v_sh, kBlockN);
  }
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  const int smem = static_cast<int>(sizeof(Smem<D>)) + 1024;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qtiles = (T + kBlockM - 1) / kBlockM;
  const long long items = static_cast<long long>(n_qtiles) * H;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < 2ll * sms ? items : 2ll * sms);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, kv_mask, seg, static_cast<__nv_bfloat16*>(out), T, L, H,
      n_qtiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 q/k/v viewed as [batch * seq_len, n_heads, head_dim] (the batch
// stride is seq_len token strides; the wrapper checks it); strides in
// elements, each a multiple of 8, pointers 16-byte aligned.  kv_mask and
// segment_ids are [batch, seq_len] int32 (contiguous) or null.  out is
// [batch, seq_len, n_heads, head_dim] contiguous.  Returns 0 when launched,
// a cudaError_t, or 100000 + the CUresult of a failed tensor-map encoding.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             const void* kv_mask, const void* segment_ids,
                             void* out, int batch, int seq_len, int n_heads,
                             int head_dim, int q_sl, int q_sh, int k_sl,
                             int k_sh, int v_sl, int v_sh, float scale,
                             void* stream) {
  if (batch <= 0 || seq_len <= 0 || n_heads <= 0 ||
      static_cast<long long>(batch) * seq_len > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int T = batch * seq_len;
  const float sl2 = scale * 1.4426950408889634f;
  const int* mask = static_cast<const int*>(kv_mask);
  const int* seg = static_cast<const int*>(segment_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) {
    return launch<32>(q, k, v, mask, seg, out, T, seq_len, n_heads, q_sl, q_sh,
                      k_sl, k_sh, v_sl, v_sh, sl2, s);
  }
  if (head_dim == 64) {
    return launch<64>(q, k, v, mask, seg, out, T, seq_len, n_heads, q_sl, q_sh,
                      k_sl, k_sh, v_sl, v_sh, sl2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_sm90_error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
