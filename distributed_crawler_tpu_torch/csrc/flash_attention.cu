// Bidirectional masked softmax attention, forward only, for Hopper (sm_90a):
// the generic routes, for every input the TMA kernel
// (csrc/flash_attention_sm90.cu) cannot address.
//
// Replaces the Pallas kernel `flash_attention` / `_flash_kernel` of
// distributed_crawler_tpu/ops/attention.py (pallas_call at :155).  It computes
// the same function: BLHD q/k/v at any head dim up to 256, f32 scores, a
// per-key padding mask and an optional same-segment mask (packed rows),
// masked probabilities exactly zero, the row sum clamped at 1e-30 (a fully
// masked row comes out as zeros), p rounded to v's dtype before P V, the
// output in the input dtype.  Two routes share one skeleton:
//
//   - "mma_sync" (bf16): both products on wgmma (bf16 in, f32 accumulate),
//     S = Q K^T with both operands in shared memory, O += P V with P from
//     registers and V as an MN-major B operand.  It takes every bf16 input
//     that TMA cannot address: head dims other than 32/64 (TinyBERT's 26),
//     rows that are not whole 16-byte units, a batch stride that is not L
//     token strides.  (The route keeps the name of the mma.sync kernel it
//     replaced, so its counts and tables continue.)
//   - "simt" (f32): both products on the tensor cores as 3xTF32: each f32
//     operand x is split once into hi = cvt.rna.tf32(x) and
//     lo = cvt.rna.tf32(x - hi), and a product is a_lo b_hi + a_hi b_lo +
//     a_hi b_hi with f32 accumulation (about 22 mantissa bits, inside the
//     f32 tolerance).  Q is split into registers once per item, P in
//     registers, and each K/V tile once in shared memory by all consumer
//     warps together (hi in place, lo beside it; up to Dp = 64, above which
//     each warp splits what it loads).  mma.sync m16n8k8 .tf32 takes its
//     fragments from 64-bit (Q, K) and 32-bit (V) shared loads of rows
//     padded against bank conflicts; wgmma would need the halves in its
//     swizzled layout, and V transposed.  (The route keeps its old name
//     too.)
//
// What bounds it on an H100 SXM (published peaks at 700 W: 3.35 TB/s,
// 989 TFLOP/s dense bf16, 495 TFLOP/s dense TF32, about 3.9e12
// exponentials/s).  bf16 at serving shapes is bound by bytes and
// exponentials, as the sm90 kernel is; f32 at 3xTF32 by the three TF32
// products (an effective 165 TFLOP/s).  So the design spends nothing on
// keys no query of a tile may see, keeps copies off the compute warps, and
// splits each f32 value once:
//
//   - The token axis is flat: a work item is 128 consecutive query tokens
//     of the [T = B*L] axis for one head, split over two consumer
//     warpgroups of 64 rows; keys come from the batch rows those queries
//     belong to, in tiles of kBlockN keys.  Token t of batch row b = t / L
//     is addressed as b * stride_b + (t - b L) * stride_l, so any strides
//     work; short buckets fill a tile.  A key is allowed for a query when
//     it is unmasked and has the query's (batch row, segment id): its tag.
//   - Tile skipping is the sm90 kernel's, exact: the producer reads each
//     candidate tile's keys' tags ahead, and a tile no row of a warpgroup
//     may see is neither loaded nor computed for it
//     (`ops/attention.key_tile_plan` is its plain description).
//   - Warp specialisation: warpgroups 0 and 1 consume, warpgroup 2
//     produces; setmaxnreg moves registers from the producers to the
//     consumers within the block's allocation.  The producer's four warps
//     make the same skip decisions from the same tags; warp 0 writes the
//     tags the consumers read, and each warp stages a quarter of Q once per
//     item and of K/V per tile, with cp.async into a ring of kStages stages
//     (16-, 8- or 4-byte copies, as wide as the operands' alignment
//     allows; plain 2-byte loads for odd bf16 head dims), zero-filling the
//     padded head columns and keys past the candidate rows (src-size 0).
//     Copying costs the SM instructions that TMA would not, so they are
//     spread over four warps (four schedulers), a row's source is found by
//     a multiply-shift division by L, and K and V share one loop.  Each
//     producer thread signals a stage twice: an mbarrier.arrive that
//     releases what it wrote, and a cp.async.mbarrier.arrive that fires
//     when its copies have landed, so no producer waits for its own copies.
//     The consumers fence the async proxy (fence.proxy.async) after they
//     acquire a stage and before wgmma reads the copies' generic-proxy
//     writes.
//   - The head dim D is rounded up to the instantiated width
//     Dp in {16, 32, 64, 128, 256}; the extra columns are zeros in shared
//     memory, so they add nothing to q.k, and P V's extra output columns
//     are never written.  bf16 tiles use the swizzle of their row width
//     (32, 64 or 128 bytes; wider rows are 64-column chunks of 128 bytes),
//     written by the copies themselves, and the wgmma descriptors name it.
//   - Persistent blocks walk the items; with two Q buffers, a block's next
//     item (its Q, its tags, its first tiles) loads while the current one
//     is computed.
//   - The online softmax runs on the f32 accumulator fragments: the running
//     max starts at -1e30, a masked score is -inf, so its exp2 is exactly 0.
//   - Launches on the caller's stream, allocates nothing, never synchronises.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kBlockM = 128;        // query rows per work item
constexpr int kWgRows = 64;         // query rows per consumer warpgroup
constexpr int kConsumerWarps = 8;
constexpr int kProducerWarps = 4;
constexpr int kThreads = 384;       // two consumer warpgroups + the producer's
constexpr int kProducerRegs = 40;   // setmaxnreg: the producer warpgroup's
constexpr float kNegInit = -1e30f;  // the running max before any key
constexpr int kNoRow = -1;          // batch row of a key no query may see
constexpr int kPastEnd = -2;        // batch row of a query row past T
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int b, l, h;  // in elements; the head dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_mask;
  const int* seg;
  void* out;
  int T, L, H, D;
  Strides sq, sk, sv;
  float scale_log2;
  int n_qtiles;
  int unit;  // bytes per copy: 16, 8, 4, or 2 (plain loads)
  unsigned l_magic;  // t / L == __umulhi(t, l_magic) >> l_shift (L > 1)
  int l_shift;
};

// The two routes' tile shapes.  Elements per tile row are the row stride
// in shared memory: bf16 rows are Dp wide and swizzled, f32 rows are
// padded (Q and K by 8 floats: conflict-free 64-bit fragment loads; V by
// 4: conflict-free 32-bit loads of two keys per lane).
template <typename T, int Dp>
struct Cfg;

template <int Dp>
struct Cfg<__nv_bfloat16, Dp> {
  using Elem = __nv_bfloat16;
  static constexpr int kBytes = 2;
  static constexpr int kSw = Dp * 2 < 128 ? Dp * 2 : 128;  // swizzle bytes
  static constexpr int kChunk = kSw / 2;       // columns per swizzle chunk
  static constexpr int kMode = kSw == 128 ? 1 : (kSw == 64 ? 2 : 3);
  static constexpr int kQStride = Dp;  // swizzled rows are not padded
  static constexpr int kKStride = Dp;
  static constexpr int kVStride = Dp;
  static constexpr int kBlockN = 64;
  static constexpr int kStages = Dp <= 64 ? 4 : (Dp == 128 ? 3 : 2);
  static constexpr int kQBufs = Dp <= 128 ? 2 : 1;
  static constexpr int kMinBlocks = Dp <= 64 ? 2 : 1;
  // setmaxnreg moves registers within the block's own allocation (384 x
  // 80 at two blocks per SM, 384 x 168 at one): 2 x 128 x 96 + 128 x 40 <=
  // 30720, 2 x 128 x 232 + 128 x 40 <= 64512.
  static constexpr int kConsumerRegs = kMinBlocks == 2 ? 96 : 232;
  static constexpr int kQElems = kBlockM * Dp;
  static constexpr int kKElems = kBlockN * Dp;
  static constexpr int kVElems = kBlockN * Dp;
  static constexpr int kLoKElems = 1, kLoVElems = 1;  // no split halves
};

template <int Dp>
struct Cfg<float, Dp> {
  using Elem = float;
  static constexpr int kBytes = 4;
  static constexpr int kQStride = Dp + 8;
  static constexpr int kKStride = Dp + 8;
  static constexpr int kVStride = Dp + 4;
  static constexpr int kBlockN = Dp == 256 ? 16 : 64;
  // Up to Dp = 64 the consumers split each K/V tile once, together, into
  // its TF32 halves (hi in place, lo beside it); wider tiles leave no room
  // for the lo halves, and each warp splits what it loads.
  static constexpr bool kPreSplit = Dp <= 64;
  // Q moves to registers at an item's start (Dp <= 64), so one buffer
  // already lets the next item's Q load during this one.
  static constexpr int kStages = Dp <= 32 ? 4 : 2;
  static constexpr int kQBufs = 1;
  static constexpr int kMinBlocks = 1;
  static constexpr int kConsumerRegs = 232;
  static constexpr bool kQInRegs = Dp <= 64;  // Q fragments held per item
  static constexpr int kQElems = kBlockM * kQStride;
  static constexpr int kKElems = kBlockN * kKStride;
  static constexpr int kVElems = kBlockN * kVStride;
  static constexpr int kLoKElems = kPreSplit ? kKElems : 1;
  static constexpr int kLoVElems = kPreSplit ? kVElems : 1;
};

template <class C>
struct Smem {
  // bf16 tiles start on 1024-byte boundaries: the swizzle is a function of
  // the shared-memory address, and the wgmma descriptors assume its
  // pattern starts at the tile.
  alignas(1024) typename C::Elem q[C::kQBufs][C::kQElems];
  alignas(1024) typename C::Elem k[C::kStages][C::kKElems];
  alignas(1024) typename C::Elem v[C::kStages][C::kVElems];
  alignas(16) typename C::Elem kl[C::kStages][C::kLoKElems];  // f32: lo
  alignas(16) typename C::Elem vl[C::kStages][C::kLoVElems];  // halves
  // (batch row, segment id) per key; read as int4 pairs
  alignas(16) int2 ktag[C::kStages][C::kBlockN];
  int tile_k0[C::kStages];            // first key token; -1 ends the item
  int tile_need[C::kStages];          // bit w: warpgroup w computes it;
                                      // bit 2 + w: every key allowed for
                                      // all of its rows
  int2 qtag[C::kQBufs][kBlockM];      // (batch row, segment id) per row
  unsigned qbits[2][kBlockM];         // producer: per warpgroup and batch
                                      // row, the segment ids in [0, 32)
  int qwide[2];                       // a segment id outside [0, 32)
  uint64_t full[C::kStages];
  uint64_t empty[C::kStages];
  uint64_t q_full[C::kQBufs];
  uint64_t q_empty[C::kQBufs];
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

// --- cp.async --------------------------------------------------------------
// `bytes` from global to shared without passing through registers; with
// src_bytes 0 the destination is zero-filled and nothing is read.
template <int kUnit>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (kUnit == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kUnit), "r"(src_bytes)
                 : "memory");
  }
}

// An arrive on `bar` that fires once every cp.async this thread issued
// before it has landed; the barrier's count includes it (noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// --- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128 B, 2 = 64 B,
// 3 = 32 B): C::kMode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
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

// d[0..N/2) += A(64x16, registers) * B(16xN, smem desc, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
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

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
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

// --- 3xTF32 ----------------------------------------------------------------
// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: `ops/attention.tf32_round` is its plain twin.  mma's .tf32 operands
// must be rounded: it would truncate the low bits of a raw f32.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d[0..3] += A(16x8, row) * B(8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a * b as three TF32 products, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_hi,
                                           const uint32_t* a_lo, uint32_t b0_hi,
                                           uint32_t b0_lo, uint32_t b1_hi,
                                           uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
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

// --- shared-memory layouts -------------------------------------------------
// Byte offset of (row, byte column) in a tile of `rows` rows.
//   bf16: 64-column chunks (or one chunk of the whole row when Dp < 64),
//   each `rows` rows of kSw bytes, swizzled as TMA's kSw-byte mode does:
//   the 16-byte granule index XOR address bits [7, 7 + log2(kSw / 16)).
//   f32: padded rows of kStride floats.
template <class C, int kRows, int kStride>
__device__ __forceinline__ uint32_t tile_offset(int row, int col_bytes) {
  if constexpr (C::kBytes == 2) {
    const int chunk = col_bytes / C::kSw;
    const uint32_t off = static_cast<uint32_t>(
        chunk * kRows * C::kSw + row * C::kSw + col_bytes % C::kSw);
    return off ^ (((off >> 7) & (C::kSw / 16 - 1)) << 4);
  } else {
    return static_cast<uint32_t>(row * kStride * 4 + col_bytes);
  }
}

// One copy of kUnit bytes at byte column cb of a source row: the bytes
// below d_bytes, zeros after them (a null row, or a column past the head
// dim: zeros, reading nothing).
template <int kUnit>
__device__ __forceinline__ void copy_unit(uint32_t dst, const char* row,
                                          int cb, int d_bytes,
                                          const char* any) {
  const bool live = cb < d_bytes && row != nullptr;
  if constexpr (kUnit >= 4) {
    const int n = d_bytes - cb < kUnit ? d_bytes - cb : kUnit;
    cp_async<kUnit>(dst, live ? row + cb : any, live ? n : 0);
  } else {
    const unsigned short x =
        live ? __ldg(reinterpret_cast<const unsigned short*>(row + cb)) : 0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
  }
}

// Copies the rows of one head that producer warp `pw` owns into kN tiles
// of the same rows (K and V share their tokens): `rows(r, src)` gives the
// source of tile row r in each tile (nullptr: zeros).  Columns [0, Dp) in
// copies of kUnit bytes, zeros past the head dim.  A lane keeps one set of
// columns for every row it copies; the four warps take interleaved rows.
template <class C, int Dp, int kRows, int kN, int kStride0, int kStride1,
          int kUnit, class Rows>
__device__ __forceinline__ void copy_rows(uint32_t dst0, uint32_t dst1,
                                          const Rows& rows, const char* any,
                                          int d_bytes, int pw, int lane) {
  constexpr int kUnits = Dp * C::kBytes / kUnit;    // per row
  constexpr int kLanes = kUnits < 32 ? kUnits : 32;  // per row at a time
  constexpr int kRowStep = 32 / kLanes;              // rows per warp pass
  constexpr int kPerLane = kUnits / kLanes;
  const int u0 = lane % kLanes;
#pragma unroll 2
  for (int r = pw * kRowStep + lane / kLanes; r < kRows;
       r += kProducerWarps * kRowStep) {
    const char* src[2] = {nullptr, nullptr};
    rows(r, src);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int cb = (u0 + k * kLanes) * kUnit;
      copy_unit<kUnit>(dst0 + tile_offset<C, kRows, kStride0>(r, cb), src[0],
                       cb, d_bytes, any);
      if constexpr (kN > 1) {
        copy_unit<kUnit>(dst1 + tile_offset<C, kRows, kStride1>(r, cb),
                         src[1], cb, d_bytes, any);
      }
    }
  }
}

template <class C, int Dp, int kRows, int kN, int kStride0, int kStride1,
          class Rows>
__device__ __forceinline__ void copy_tiles(void* tile0, void* tile1,
                                           const Rows& rows, const void* any,
                                           const Params& p, int unit, int pw,
                                           int lane) {
  const uint32_t d0 = smem_u32(tile0), d1 = smem_u32(tile1);
  const auto* a = static_cast<const char*>(any);
  const int db = p.D * C::kBytes;
  // The copies of one head are as wide as its rows' alignment allows.
  if (unit == 16) {
    copy_rows<C, Dp, kRows, kN, kStride0, kStride1, 16>(d0, d1, rows, a, db,
                                                        pw, lane);
  } else if (unit == 8) {
    copy_rows<C, Dp, kRows, kN, kStride0, kStride1, 8>(d0, d1, rows, a, db,
                                                       pw, lane);
  } else if (unit == 4) {
    copy_rows<C, Dp, kRows, kN, kStride0, kStride1, 4>(d0, d1, rows, a, db,
                                                       pw, lane);
  } else if constexpr (C::kBytes == 2) {
    copy_rows<C, Dp, kRows, kN, kStride0, kStride1, 2>(d0, d1, rows, a, db,
                                                       pw, lane);
  }
}

// The four producer warps meet here (named barrier 1).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kProducerWarps) : "memory");
}

// Whether a key of batch row b (rel = b - the block's first row) and
// segment id seg is allowed for some query row of consumer warpgroup w.
template <class C>
__device__ __forceinline__ bool wg_sees(const Smem<C>& sm, const int2* qtag,
                                        int w, int rel, int b, int seg) {
  if (static_cast<unsigned>(seg) < 32u) return (sm.qbits[w][rel] >> seg) & 1u;
  if (!sm.qwide[w]) return false;
  for (int i = 0; i < kWgRows; ++i) {
    const int2 t = qtag[w * kWgRows + i];
    if (t.x == b && t.y == seg) return true;
  }
  return false;
}

// t / L by a multiply and a shift (Params::l_magic, l_shift), for the
// token counts a launch takes (t < 2^31).
__device__ __forceinline__ int div_l(int t, const Params& p) {
  return p.L == 1 ? t
                  : static_cast<int>(__umulhi(static_cast<unsigned>(t),
                                              p.l_magic) >>
                                     p.l_shift);
}

// The first byte of token t's row (batch row b) of the head at `head`.
__device__ __forceinline__ const char* token_row(const char* head, int t,
                                                 int b, const Params& p,
                                                 const Strides& s, int bytes) {
  return head + (static_cast<long long>(b) * s.b +
                 static_cast<long long>(t - b * p.L) * s.l) *
                    bytes;
}

// The producer warpgroup.  For each work item (128 query rows of one head)
// it stages Q into a Q buffer, then walks the item's candidate key tiles,
// and closes the item with a sentinel stage.  Its four warps make the same
// decisions from the same tags; warp 0 alone writes the tags the consumers
// read, and each warp copies its share of every tile's rows.
template <class C, int Dp>
__device__ __forceinline__ void producer(Smem<C>& sm, const Params& p,
                                         int n_items) {
  constexpr int kBlockN = C::kBlockN;
  constexpr int kPer = (kBlockN + 31) / 32;  // keys per lane per tile
  constexpr int kQStride = C::kQStride, kKStride = C::kKStride;
  constexpr int kVStride = C::kVStride;
  constexpr int kBytes = C::kBytes;
  const int lane = threadIdx.x % 32;
  const int pw = threadIdx.x / 32 - kConsumerWarps;  // producer warp 0..3
  const int T = p.T, L = p.L;
  const int* kv_mask = p.kv_mask;
  const int* seg = p.seg;
  int stage = 0, phase = 0;  // the K/V ring
  int qb = 0, qphase = 0;    // the Q buffers
  // Each producer thread arrives twice on a stage's barrier: at once
  // (releasing what it wrote) and when its copies have landed.
  auto signal = [&](uint64_t* bar) {
    cp_async_arrive(bar);
    mbar_arrive(bar);
  };
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % p.n_qtiles) * kBlockM;
    const int h = item / p.n_qtiles;
    const char* q_head = static_cast<const char*>(p.q) +
                         static_cast<long long>(h) * p.sq.h * kBytes;
    const char* k_head = static_cast<const char*>(p.k) +
                         static_cast<long long>(h) * p.sk.h * kBytes;
    const char* v_head = static_cast<const char*>(p.v) +
                         static_cast<long long>(h) * p.sv.h * kBytes;
    // This head's copy width: the launch's (base and batch and token
    // strides), narrowed by the alignment of the head's offset.
    const unsigned long long hoff =
        static_cast<unsigned long long>(q_head - static_cast<const char*>(
                                                     p.q)) |
        static_cast<unsigned long long>(k_head - static_cast<const char*>(
                                                     p.k)) |
        static_cast<unsigned long long>(v_head - static_cast<const char*>(
                                                     p.v));
    const int unit =
        hoff == 0 ? p.unit
                  : static_cast<int>(min(static_cast<unsigned long long>(
                                             p.unit),
                                         hoff & (~hoff + 1)));
    // Candidate keys: the tokens of the batch rows the queries belong to.
    const int b_lo = div_l(q0, p);
    const int b_hi = div_l(min(q0 + kBlockM, T) - 1, p);
    const int key_begin = b_lo * L;
    const int key_end = (b_hi + 1) * L;
    // Each key's mask and segment id, loaded two tiles ahead of use.
    auto fetch = [&](int k0, int* vm, int* sg) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = lane + 32 * i;
        const int t = k0 + j;
        vm[i] = 0;
        sg[i] = 0;
        if (j < kBlockN && t < key_end) {
          vm[i] = kv_mask != nullptr ? __ldg(kv_mask + t) : 1;
          sg[i] = seg != nullptr ? __ldg(seg + t) : 0;
        }
      }
    };
    int vm_a[kPer], sg_a[kPer], vm_b[kPer], sg_b[kPer];
    fetch(key_begin, vm_a, sg_a);
    fetch(key_begin + kBlockN, vm_b, sg_b);

    mbar_wait(&sm.q_empty[qb], qphase ^ 1);
    producer_sync();  // every warp is done with the last item's query sets
    int2* qtag = sm.qtag[qb];
    if (pw == 0) {
      // The queries' tags, and per warpgroup the set of (batch row,
      // segment).
      for (int i = lane; i < 2 * kBlockM; i += 32) (&sm.qbits[0][0])[i] = 0u;
      if (lane < 2) sm.qwide[lane] = 0;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kBlockM / 32; ++r) {
        const int i = lane + 32 * r;
        const int t = q0 + i;
        int2 tag = make_int2(kPastEnd, 0);
        if (t < T) {
          const int b = div_l(t, p);
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
    }
    // Q rows past T are zeros.
    auto q_rows = [&](int r, const char** src) {
      const int t = q0 + r;
      if (t < T) src[0] = token_row(q_head, t, div_l(t, p), p, p.sq, kBytes);
    };
    copy_tiles<C, Dp, kBlockM, 1, kQStride, kQStride>(sm.q[qb], sm.q[qb],
                                                      q_rows, p.q, p, unit,
                                                      pw, lane);
    signal(&sm.q_full[qb]);
    producer_sync();  // warp 0's query tags and sets, for every warp
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
        if (vm[i] != 0) {  // a key of the tile, before key_end, unmasked
          const int b = div_l(k0 + lane + 32 * i, p);
          tag[i] = make_int2(b, sg[i]);
          if (wg_sees(sm, qtag, 0, b - b_lo, b, sg[i])) need |= 1u;
          if (wg_sees(sm, qtag, 1, b - b_lo, b, sg[i])) need |= 2u;
        }
        if (lane + 32 * i < kBlockN) {
          whole0 = whole0 && is_uni[0] && tag[i].x == uni[0].x &&
                   tag[i].y == uni[0].y;
          whole1 = whole1 && is_uni[1] && tag[i].x == uni[1].x &&
                   tag[i].y == uni[1].y;
        }
      }
      need = __reduce_or_sync(0xffffffffu, need);
      if (need == 0) continue;  // no row may see a key of this tile
      // Bits 2 and 3: warpgroup 0 / 1 sees every key of the tile.
      need |= (__all_sync(0xffffffffu, whole0) ? 4u : 0u) |
              (__all_sync(0xffffffffu, whole1) ? 8u : 0u);
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (pw == 0) {
        if (lane == 0) {
          sm.tile_k0[stage] = k0;
          sm.tile_need[stage] = static_cast<int>(need);
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (lane + 32 * i < kBlockN) sm.ktag[stage][lane + 32 * i] = tag[i];
        }
      }
      // Keys past the candidate rows are zeros: their tags mask them.
      auto kv_rows = [&](int r, const char** src) {
        const int t = k0 + r;
        if (t < key_end) {
          const int b = div_l(t, p);
          src[0] = token_row(k_head, t, b, p, p.sk, kBytes);
          src[1] = token_row(v_head, t, b, p, p.sv, kBytes);
        }
      };
      copy_tiles<C, Dp, kBlockN, 2, kKStride, kVStride>(
          sm.k[stage], sm.v[stage], kv_rows, p.k, p, unit, pw, lane);
      signal(&sm.full[stage]);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // The item's end: a sentinel stage.
    mbar_wait(&sm.empty[stage], phase ^ 1);
    if (pw == 0 && lane == 0) sm.tile_k0[stage] = -1;
    signal(&sm.full[stage]);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
    if (++qb == C::kQBufs) {
      qb = 0;
      qphase ^= 1;
    }
  }
}

// Masks this tile's scores by tags (unless the tile is whole for the
// warpgroup), scales them into the log2 domain and folds them into the
// running max and sum; on return s holds p = exp2(s - m), exactly 0 for a
// masked key, and o has been rescaled.  s[4n + e]: row r0 (e < 2) or
// r0 + 8, key 8n + c + (e & 1); the same layout for wgmma's and mma.sync's
// accumulators.
template <int kNB, int kNO>
__device__ __forceinline__ void online_softmax(float* s, float* o,
                                               const int2* ktag, int flags,
                                               int2 qt0, int2 qt1, int c,
                                               float scale_log2, float& m0,
                                               float& m1, float& l0,
                                               float& l1) {
  const float neg_inf = __int_as_float(0xff800000);  // -inf
  if (flags & 4) {
#pragma unroll
    for (int i = 0; i < 4 * kNB; ++i) s[i] *= scale_log2;
  } else {
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int4 kt = *reinterpret_cast<const int4*>(&ktag[8 * n + c]);
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
  for (int n = 0; n < kNB; ++n) {
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
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    s[4 * n + 0] = ex2(s[4 * n + 0] - m0);
    s[4 * n + 1] = ex2(s[4 * n + 1] - m0);
    s[4 * n + 2] = ex2(s[4 * n + 2] - m1);
    s[4 * n + 3] = ex2(s[4 * n + 3] - m1);
    l0 += s[4 * n + 0] + s[4 * n + 1];
    l1 += s[4 * n + 2] + s[4 * n + 3];
  }
}

// o / l into out's rows r0 and r0 + 8 (token q0 + r), columns below D.
// o[4n + e]: column 8n + c + (e & 1) of row r0 (e < 2) or r0 + 8.
template <typename T, int kNO>
__device__ __forceinline__ void write_rows(const float* o, float l0, float l1,
                                           T* out, int q0, int r0, int c,
                                           const Params& p, int h) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int D = p.D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q0 + r0 + 8 * half;
    if (t >= p.T) continue;
    const float inv = half ? inv1 : inv0;
    T* op = out + (static_cast<int64_t>(t) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < kNO / 4; ++n) {
      const int col = 8 * n + c;
      const float x0 = o[4 * n + 2 * half] * inv;
      const float x1 = o[4 * n + 2 * half + 1] * inv;
      if (col + 1 < D && (D & 1) == 0) {
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(op + col) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          *reinterpret_cast<float2*>(op + col) = make_float2(x0, x1);
        }
      } else {
        if constexpr (sizeof(T) == 2) {
          if (col < D) op[col] = __float2bfloat16(x0);
          if (col + 1 < D) op[col + 1] = __float2bfloat16(x1);
        } else {
          if (col < D) op[col] = x0;
          if (col + 1 < D) op[col + 1] = x1;
        }
      }
    }
  }
}

// A bf16 consumer warpgroup: 64 query rows of each work item on wgmma.
template <int Dp>
__device__ __forceinline__ void consumer_bf16(
    Smem<Cfg<__nv_bfloat16, Dp>>& sm, const Params& p, int n_items) {
  using C = Cfg<__nv_bfloat16, Dp>;
  constexpr int kSw = C::kSw;
  constexpr uint32_t kMode = C::kMode;
  constexpr uint32_t kGroup = 8 * kSw;  // 8 rows: one swizzle atom
  constexpr int kChunk = C::kChunk;     // columns per wgmma of P V
  constexpr int kNO = Dp / 2;           // O accumulator registers
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int c = 2 * (lane % 4);                        // first of 2 columns
  const int r0 = wg * kWgRows + warp * 16 + lane / 4;  // and r0 + 8
  auto* out = static_cast<__nv_bfloat16*>(p.out);

  int stage = 0, phase = 0;
  int qb = 0, qphase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % p.n_qtiles) * kBlockM;
    const int h = item / p.n_qtiles;
    mbar_wait(&sm.q_full[qb], qphase);
    fence_proxy_async();  // the copies' generic writes, before wgmma reads
    const int2 qt0 = sm.qtag[qb][r0];
    const int2 qt1 = sm.qtag[qb][r0 + 8];
    // This warpgroup's 64 rows of each 128-row chunk of Q.
    const uint32_t qbase = smem_u32(sm.q[qb]) + wg * kWgRows * kSw;

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
        fence_proxy_async();
        // S = Q K^T, 16 columns of the head dim per product; the first
        // overwrites s (scale-d 0).
        float s[32];
        const uint32_t kbase = smem_u32(sm.k[stage]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Dp / 16; ++kk) {
          const int cb = 32 * kk;  // byte column: chunk, and within it
          const uint32_t qa = qbase + (cb / kSw) * kBlockM * kSw + cb % kSw;
          const uint32_t ka =
              kbase + (cb / kSw) * C::kBlockN * kSw + cb % kSw;
          wgmma_ss_m64n64k16(s, make_desc(qa, 16, kGroup, kMode),
                             make_desc(ka, 16, kGroup, kMode), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(s);

        online_softmax<8, kNO>(s, o, sm.ktag[stage], flags, qt0, qt1, c,
                               p.scale_log2, m0, m1, l0, l1);
        // P in bf16 as wgmma A fragments, one per 16 keys.
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        // O += P V; V is [keys][Dp], Dp contiguous: an MN-major B operand,
        // one product per 16 keys and chunk of kChunk columns.
        const uint32_t vbase = smem_u32(sm.v[stage]);
        fence_regs<kNO>(o);
        fence_regs<16>(&pa[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int ch = 0; ch < Dp / kChunk; ++ch) {
            const uint32_t va =
                vbase + ch * C::kBlockN * kSw + 16 * kk * kSw;  // 16 keys
            wgmma_rs<kChunk>(o + ch * (kChunk / 2), pa[kk],
                             make_desc(va, kGroup, kGroup, kMode));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<kNO>(o);
        fence_regs<16>(&pa[0][0]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (k0 < 0) break;
    }
    // Q and its tags are read no more: the producer may stage a later item
    // into this buffer while the output is written.
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.q_empty[qb]);
    if (++qb == C::kQBufs) {
      qb = 0;
      qphase ^= 1;
    }
    // o's chunk ch holds columns [ch kChunk, ch kChunk + kChunk) in the
    // same fragment layout, so columns 8n + c index it straight through.
    write_rows<__nv_bfloat16, kNO>(o, l0, l1, out, q0, r0, c, p, h);
  }
}

// The eight consumer warps meet here (named barrier 2).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

// x's four values replaced by their TF32 hi halves, the lo halves to lo.
__device__ __forceinline__ void split_quad(float* x, float* lo) {
  const float4 v = *reinterpret_cast<const float4*>(x);
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(x) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// A K/V tile split into TF32 halves by all consumer threads together, each
// value once (not once per warp that reads it).
template <int Dp>
__device__ __forceinline__ void split_tile(Smem<Cfg<float, Dp>>& sm,
                                           int stage) {
  using C = Cfg<float, Dp>;
  constexpr int kQuads = Dp / 4;
  for (int i = threadIdx.x; i < C::kBlockN * kQuads;
       i += 32 * kConsumerWarps) {
    const int r = i / kQuads, c = (i % kQuads) * 4;
    split_quad(sm.k[stage] + r * C::kKStride + c,
               sm.kl[stage] + r * C::kKStride + c);
    split_quad(sm.v[stage] + r * C::kVStride + c,
               sm.vl[stage] + r * C::kVStride + c);
  }
}

// An f32 consumer warp: 16 query rows of each work item on mma.sync
// m16n8k8 .tf32, each product as three (3xTF32).  The reduction index of
// a fragment is relabelled so that each lane's two values are neighbours
// in memory: k = t reads column 2t, k = t + 4 column 2t + 1 (Q K^T, the
// same for both operands), and for P V key 8j + 2t and 8j + 2t + 1, which
// is where the S accumulator keeps a lane's two probabilities.
template <int Dp>
__device__ __forceinline__ void consumer_f32(Smem<Cfg<float, Dp>>& sm,
                                             const Params& p, int n_items) {
  using C = Cfg<float, Dp>;
  constexpr int kNB = C::kBlockN / 8;  // n-blocks of S, k-steps of P V
  constexpr int kKS = Dp / 8;          // k-steps of Q K^T
  constexpr int kNO = Dp / 2;          // O accumulator registers
  constexpr int kQS = C::kQStride, kKSt = C::kKStride, kVS = C::kVStride;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c = 2 * t4;
  const int r0 = wg * kWgRows + warp * 16 + g;  // and r0 + 8
  auto* out = static_cast<float*>(p.out);

  int stage = 0, phase = 0;
  int qb = 0, qphase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % p.n_qtiles) * kBlockM;
    const int h = item / p.n_qtiles;
    mbar_wait(&sm.q_full[qb], qphase);
    const int2 qt0 = sm.qtag[qb][r0];
    const int2 qt1 = sm.qtag[qb][r0 + 8];
    const float* qrow0 = sm.q[qb] + r0 * kQS + c;
    const float* qrow1 = qrow0 + 8 * kQS;
    // Q as A fragments: a0/a2 row r0, a1/a3 row r0 + 8; k = t and t + 4
    // read columns 8 ks + 2t and 8 ks + 2t + 1.
    auto q_frag = [&](int ks, uint32_t* hi, uint32_t* lo) {
      const float2 x0 = *reinterpret_cast<const float2*>(qrow0 + 8 * ks);
      const float2 x1 = *reinterpret_cast<const float2*>(qrow1 + 8 * ks);
      split_tf32(x0.x, hi[0], lo[0]);
      split_tf32(x1.x, hi[1], lo[1]);
      split_tf32(x0.y, hi[2], lo[2]);
      split_tf32(x1.y, hi[3], lo[3]);
    };
    uint32_t qh[C::kQInRegs ? kKS : 1][4], ql[C::kQInRegs ? kKS : 1][4];
    if constexpr (C::kQInRegs) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) q_frag(ks, qh[ks], ql[ks]);
      // Q is in registers: the producer may stage a later item.
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.q_empty[qb]);
    }

    float o[kNO];
#pragma unroll
    for (int i = 0; i < kNO; ++i) o[i] = 0.f;
    float m0 = kNegInit, m1 = kNegInit;
    float l0 = 0.f, l1 = 0.f;

    for (;;) {
      mbar_wait(&sm.full[stage], phase);
      const int k0 = sm.tile_k0[stage];
      const int flags = sm.tile_need[stage] >> wg;
      if constexpr (C::kPreSplit) {
        if (k0 >= 0) {  // some warpgroup computes it: every warp splits
          split_tile<Dp>(sm, stage);
          consumer_sync();
        }
      }
      if (k0 >= 0 && (flags & 1)) {
        float s[4 * kNB];
#pragma unroll
        for (int i = 0; i < 4 * kNB; ++i) s[i] = 0.f;
        const float* kt = sm.k[stage] + g * kKSt + c;
        const float* ktl = sm.kl[stage] + (C::kPreSplit ? g * kKSt + c : 0);
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          uint32_t ah[4], al[4];
          if constexpr (C::kQInRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i] = qh[ks][i];
              al[i] = ql[ks][i];
            }
          } else {
            q_frag(ks, ah, al);
          }
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            // B: key 8n + g, columns 8 ks + 2t (k = t) and + 1 (k = t + 4).
            const int at = 8 * n * kKSt + 8 * ks;
            const float2 y = *reinterpret_cast<const float2*>(kt + at);
            uint32_t b0h, b0l, b1h, b1l;
            if constexpr (C::kPreSplit) {
              const float2 yl = *reinterpret_cast<const float2*>(ktl + at);
              b0h = __float_as_uint(y.x);
              b1h = __float_as_uint(y.y);
              b0l = __float_as_uint(yl.x);
              b1l = __float_as_uint(yl.y);
            } else {
              split_tf32(y.x, b0h, b0l);
              split_tf32(y.y, b1h, b1l);
            }
            mma_3xtf32(s + 4 * n, ah, al, b0h, b0l, b1h, b1l);
          }
        }

        online_softmax<kNB, kNO>(s, o, sm.ktag[stage], flags, qt0, qt1, c,
                                 p.scale_log2, m0, m1, l0, l1);

        // O += P V: for keys 8j..8j+7, a0/a1 are rows r0/r0+8 at key
        // 8j + 2t (k = t), a2/a3 at key 8j + 2t + 1 (k = t + 4).
        const float* vt = sm.v[stage] + c * kVS + g;
        const float* vtl = sm.vl[stage] + (C::kPreSplit ? c * kVS + g : 0);
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          uint32_t ph[4], pl[4];
          split_tf32(s[4 * j + 0], ph[0], pl[0]);
          split_tf32(s[4 * j + 2], ph[1], pl[1]);
          split_tf32(s[4 * j + 1], ph[2], pl[2]);
          split_tf32(s[4 * j + 3], ph[3], pl[3]);
#pragma unroll
          for (int n = 0; n < Dp / 8; ++n) {
            // B: column 8n + g, keys 8j + 2t and 8j + 2t + 1.
            const int at0 = (8 * j) * kVS + 8 * n, at1 = at0 + kVS;
            uint32_t b0h, b0l, b1h, b1l;
            if constexpr (C::kPreSplit) {
              b0h = __float_as_uint(vt[at0]);
              b1h = __float_as_uint(vt[at1]);
              b0l = __float_as_uint(vtl[at0]);
              b1l = __float_as_uint(vtl[at1]);
            } else {
              split_tf32(vt[at0], b0h, b0l);
              split_tf32(vt[at1], b1h, b1l);
            }
            mma_3xtf32(o + 4 * n, ph, pl, b0h, b0l, b1h, b1l);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (k0 < 0) break;
    }
    if constexpr (!C::kQInRegs) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.q_empty[qb]);
    }
    if (++qb == C::kQBufs) {
      qb = 0;
      qphase ^= 1;
    }
    write_rows<float, kNO>(o, l0, l1, out, q0, r0, c, p, h);
  }
}

// Persistent: each block walks work items blockIdx.x, + gridDim.x, ...;
// item i is query tile i % n_qtiles of head i / n_qtiles, so the blocks
// running at one time share their heads' K/V in L2.
template <typename T, int Dp>
__global__ void __launch_bounds__(kThreads, Cfg<T, Dp>::kMinBlocks)
flash_fwd_kernel(const Params p) {
  using C = Cfg<T, Dp>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(smem_raw + pad);
  const int n_items = p.n_qtiles * p.H;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      // Every producer thread, twice; one lane per consumer warp.
      mbar_init(&sm.full[i], 2 * 32 * kProducerWarps);
      mbar_init(&sm.empty[i], kConsumerWarps);
    }
    for (int i = 0; i < C::kQBufs; ++i) {
      mbar_init(&sm.q_full[i], 2 * 32 * kProducerWarps);
      mbar_init(&sm.q_empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    producer<C, Dp>(sm, p, n_items);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::kConsumerRegs));
    if constexpr (C::kBytes == 2) {
      consumer_bf16<Dp>(sm, p, n_items);
    } else {
      consumer_f32<Dp>(sm, p, n_items);
    }
  }
}

// --- host --------------------------------------------------------------------
// The widest copy (16, 8, 4 or 2 bytes) that the operand's base and its
// batch and token strides allow (a stride over an axis of size 1 is never
// used); each head narrows it by its own offset, and a row's last copy may
// be partial.  A bf16 row start that is only 2-byte aligned takes plain
// 2-byte loads.
int unit_bytes(const void* x, const Strides& s, int B, int L, int bytes) {
  uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if (B > 1) a |= static_cast<uintptr_t>(s.b) * bytes;
  if (L > 1) a |= static_cast<uintptr_t>(s.l) * bytes;
  for (int u = 16; u > 2; u /= 2) {
    if (a % u == 0) return u;
  }
  return 2;
}

template <typename T, int Dp>
cudaError_t launch(Params p, cudaStream_t stream) {
  using C = Cfg<T, Dp>;
  const int smem = static_cast<int>(sizeof(Smem<C>)) + 1024;
  static bool configured = false;
  static int per_sm = 0;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return e;
  if (!configured) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, Dp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    // setmaxnreg.inc waits until the block's allocation has room: refuse a
    // build whose register count would leave it waiting forever.
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, flash_fwd_kernel<T, Dp>);
    if (e != cudaSuccess) return e;
    if (attr.numRegs * kThreads <
        32 * kProducerWarps * kProducerRegs + 256 * C::kConsumerRegs) {
      return cudaErrorInvalidConfiguration;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_fwd_kernel<T, Dp>, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    configured = true;
  }
  p.n_qtiles = (p.T + kBlockM - 1) / kBlockM;
  const long long items = static_cast<long long>(p.n_qtiles) * p.H;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(items < slots ? items : slots);
  flash_fwd_kernel<T, Dp><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_padded(const Params& p, cudaStream_t stream) {
  // The head dim rounded up to an instantiated width.
  if (p.D <= 16) return launch<T, 16>(p, stream);
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  if (p.D <= 256) return launch<T, 256>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the 3xTF32 route), 1 = bfloat16 (the wgmma route).
// q/k/v are [batch, seq_len, n_heads, head_dim] with the head dim
// contiguous and any (b, l, h) strides, in elements; head_dim 1-256.
// kv_mask and segment_ids are [B, L] int32 (contiguous) or null.  out is
// [B, L, H, D] contiguous.  Returns the cudaError_t of the launch
// (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* kv_mask, const void* segment_ids,
                        void* out, int batch, int seq_len, int n_heads,
                        int head_dim, int q_sb, int q_sl, int q_sh, int k_sb,
                        int k_sl, int k_sh, int v_sb, int v_sl, int v_sh,
                        float scale, int dtype, void* stream) {
  if (batch <= 0 || seq_len <= 0 || n_heads <= 0 || head_dim <= 0 ||
      head_dim > 256 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(batch) * seq_len > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.seg = static_cast<const int*>(segment_ids);
  p.out = out;
  p.T = batch * seq_len;
  p.L = seq_len;
  p.H = n_heads;
  p.D = head_dim;
  p.sq = Strides{q_sb, q_sl, q_sh};
  p.sk = Strides{k_sb, k_sl, k_sh};
  p.sv = Strides{v_sb, v_sl, v_sh};
  p.scale_log2 = scale * kLog2e;
  // t / L == floor(t * M / 2^(31 + s)) for t < 2^31, with s = ceil(log2 L)
  // and M = floor(2^(31 + s) / L) + 1 < 2^32: the error t (M - 2^(31+s)/L)
  // / 2^(31+s) stays below 2^-s <= 1/L.
  if (seq_len > 1) {
    int sh = 0;
    while ((1ll << sh) < seq_len) ++sh;
    p.l_magic = static_cast<unsigned>((1ull << (31 + sh)) / seq_len + 1);
    p.l_shift = sh - 1;
  }
  const int bytes = dtype == 1 ? 2 : 4;
  const void* ops[3] = {q, k, v};
  const Strides* strides[3] = {&p.sq, &p.sk, &p.sv};
  p.unit = 16;
  for (int i = 0; i < 3; ++i) {
    const int u = unit_bytes(ops[i], *strides[i], batch, seq_len, bytes);
    p.unit = u < p.unit ? u : p.unit;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 1 ? launch_padded<__nv_bfloat16>(p, s)
                                   : launch_padded<float>(p, s);
  return static_cast<int>(e);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
