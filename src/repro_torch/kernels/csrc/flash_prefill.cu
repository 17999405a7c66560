// Flash prefill attention for Hopper (sm_90a), with a plain C interface for
// ctypes (kernels/_build.py builds this file with nvcc,
// kernels/flash_prefill.py binds and launches it).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill.py:
// flash_prefill_attention (_flash_kernel): causal or sliding-window GQA
// attention over a whole sequence, q (b, n, h, hd) against k, v (b, m, g,
// hd), h = g * p, with fp32 logits scaled by hd^-0.5, keys at or past m
// masked, the causal mask k_pos <= q_pos, the window k_pos > q_pos - window,
// masked logits at -1e30, an fp32 online softmax (max, sumexp, acc)
// corrected by exp(m_prev - m_new), the softmax weights cast to bf16 before
// the value product (accumulated in fp32), and the output acc / max(l,
// 1e-30). One generalisation: query row i sits at position q_offset + i
// (the suffix prefill over cached keys, the reference's
// flash_chunked_attention(q_offset=)).
//
// What bounds it on an H100: operations. A causal prefill of n tokens does
// 2 * n^2 * hd * h multiply-adds' worth of operations (both products, half
// the (q, k) pairs): 274.9 GFLOP at n 8192, h 16, hd 128, about 278 us at
// 989 TFLOP/s, against ~101 MB of q, K, V and output, about 30 us at
// 3.35 TB/s. So the tensor cores must do the work and the logits must never
// reach device memory.
//
// What the design does about it:
//   * one CTA of 4 warps per (batch, kv head, tile of 64 query rows); the
//     rows of a kv head are its p query heads interleaved by position (row
//     r is position r / p of head gi * p + r % p), so each K/V block staged
//     in shared memory serves all p heads of the group, and q and the
//     output are read and written in their (b, n, h, hd) layout with
//     strides, never transposed;
//   * K/V blocks of 64 keys are staged by cp.async into a two-stage ring;
//     both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate), the running state stays in registers (the helpers
//     of decode_common.cuh);
//   * the loop over key blocks stops at the tile's causal limit
//     (q_offset + its last position) and, under a window, starts at the
//     block holding its first position's lower edge: no block wholly
//     outside is read (the Pallas kernel still copies them in); a warp
//     whose 16 rows see none of a block skips its products;
//   * tiles are launched longest first (the last positions see the most
//     keys), so the causal work spreads evenly over the 132 SMs.
// Blocks wholly masked for a row are exact to skip: visited before the
// row's first live key they leave finite garbage under m = -1e30 that the
// first live block wipes (its correction exp(-1e30 - m_new) is 0);
// visited after, they add 0.
//
// bf16 only: the wrapper raises TypeError for any other dtype on the card
// (float32 runs the plain version on the CPU).

#include "decode_common.cuh"

namespace flash_prefill {

using bifurcated::cp_async16;
using bifurcated::cp_async_commit;
using bifurcated::cp_async_wait_1;
using bifurcated::kBlockN;
using bifurcated::kMinL;
using bifurcated::kNegInf;
using bifurcated::kPad;
using bifurcated::kRowTile;
using bifurcated::kThreads;
using bifurcated::ldmatrix_x4_trans;
using bifurcated::load_pair;
using bifurcated::mma_bf16;
using bifurcated::pack_bf16;

struct Params {
  const __nv_bfloat16* q;   // (b, n, h, HD)
  const __nv_bfloat16* k;   // (b, m, g, HD)
  const __nv_bfloat16* v;
  __nv_bfloat16* out;       // (b, n, h, HD)
  int b, n, m, h, g, p;
  int rows;                 // n * p: one kv head's query rows
  int tiles;                // ceil(rows / kRowTile)
  int q_offset, window, causal;
  float scale;
};

template <int HD>
constexpr int smem_bytes() {
  return 2 * 2 * kBlockN * (HD + kPad) * 2;   // K and V, two stages, bf16
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const Params a) {
  constexpr int SROW = HD + kPad;
  constexpr int STAGE = kBlockN * SROW;
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 2 * STAGE;

  // longest tiles first: the grid's leading CTAs take the last tiles of
  // every (batch, kv head)
  const int heads = a.g * a.b;
  const int tile = a.tiles - 1 - static_cast<int>(blockIdx.x) / heads;
  const int gi = static_cast<int>(blockIdx.x) % heads % a.g;
  const int bi = static_cast<int>(blockIdx.x) % heads / a.g;
  const int row0 = tile * kRowTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wrow0 = row0 + warp * 16;
  const int ra = wrow0 + gr, rb = ra + 8;
  const bool va = ra < a.rows, vb = rb < a.rows;
  const int pos_a = a.q_offset + ra / a.p, pos_b = a.q_offset + rb / a.p;

  // the CTA's key range: [block of its first row's window edge, its last
  // row's causal limit)
  const int last_row = min(row0 + kRowTile, a.rows) - 1;
  const int col_end =
      a.causal ? min(a.m, a.q_offset + last_row / a.p + 1) : a.m;
  int col_begin =
      a.window > 0 ? max(0, a.q_offset + row0 / a.p - a.window + 1) : 0;
  col_begin -= col_begin % kBlockN;
  // the warp's own range, for skipping its products
  const bool warp_on = wrow0 < a.rows;
  const int wpos_lo = a.q_offset + wrow0 / a.p;
  const int wpos_hi = a.q_offset + min(wrow0 + 15, a.rows - 1) / a.p;

  // q rows in place: position r / p of query head gi * p + r % p
  auto row_off = [&](int r) -> size_t {
    return ((static_cast<size_t>(bi) * a.n + r / a.p) * a.h + gi * a.p +
            r % a.p) * HD;
  };
  const size_t qa = va ? row_off(ra) : 0, qb = vb ? row_off(rb) : 0;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt) {
    const int c = kt * 16 + 2 * tq;
    qf[kt][0] = load_pair(a.q + qa + c, va);
    qf[kt][1] = load_pair(a.q + qb + c, vb);
    qf[kt][2] = load_pair(a.q + qa + c + 8, va);
    qf[kt][3] = load_pair(a.q + qb + c + 8, vb);
  }
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float mrun[2] = {kNegInf, kNegInf}, lrun[2] = {0.f, 0.f};

  // key col of kv head gi: row (bi * m + col) * g + gi of the (b*m*g, HD)
  // slabs
  const size_t kv_base = (static_cast<size_t>(bi) * a.m * a.g + gi) * HD;
  const size_t kv_stride = static_cast<size_t>(a.g) * HD;
  auto stage = [&](int s, int col0) {
    for (int c = threadIdx.x; c < kBlockN * CHUNKS; c += kThreads) {
      const int r = c / CHUNKS, ch = c % CHUNKS;
      const int col = col0 + r;
      const bool valid = col < col_end;
      const size_t off = valid ? kv_base + col * kv_stride + ch * 8 : 0;
      cp_async16(sK + s * STAGE + r * SROW + ch * 8, a.k + off, valid);
      cp_async16(sV + s * STAGE + r * SROW + ch * 8, a.v + off, valid);
    }
  };

  const int nblk = (col_end - col_begin + kBlockN - 1) / kBlockN;
  if (nblk > 0) {
    stage(0, col_begin);
    cp_async_commit();
  }
  for (int blk = 0; blk < nblk; ++blk) {
    const int cur = blk & 1;
    const int col0 = col_begin + blk * kBlockN;
    if (blk + 1 < nblk) stage(cur ^ 1, col0 + kBlockN);
    cp_async_commit();
    cp_async_wait_1();  // every group but the newest is done: block blk
    __syncthreads();
    const __nv_bfloat16* Ks = sK + cur * STAGE;
    const __nv_bfloat16* Vs = sV + cur * STAGE;

    bool active = warp_on;
    if (a.causal) active = active && col0 <= wpos_hi;
    if (a.window > 0) active = active && col0 + kBlockN > wpos_lo - a.window + 1;
    if (active) {
      float s[kBlockN / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < HD / 16; ++kt) {
          const __nv_bfloat16* kp = Ks + (nt * 8 + gr) * SROW + kt * 16 + 2 * tq;
          mma_bf16(s[nt], qf[kt], *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
      // scale, mask, and the online update of rows gr (i=0) and gr+8 (i=1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool row_ok = i ? vb : va;
        const int pos = i ? pos_b : pos_a;
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + nt * 8 + 2 * tq + e;
            bool valid = row_ok && col < a.m;
            if (a.causal) valid = valid && col <= pos;
            if (a.window > 0) valid = valid && col > pos - a.window;
            const float x = valid ? s[nt][2 * i + e] * a.scale : kNegInf;
            s[nt][2 * i + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrun[i], mx);
        const float corr = expf(mrun[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = expf(s[nt][2 * i + e] - m_new);
            sum += pe;
            s[nt][2 * i + e] = pe;
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        lrun[i] = lrun[i] * corr + sum;
        mrun[i] = m_new;
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          o[nt][2 * i] *= corr;
          o[nt][2 * i + 1] *= corr;
        }
      }
      // acc += P V, P cast to bf16 as the A operand straight from registers
#pragma unroll
      for (int kt = 0; kt < kBlockN / 16; ++kt) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
        const int mi = lane >> 3, r = lane & 7;
        const int key = kt * 16 + r + ((mi & 1) ? 8 : 0);
#pragma unroll
        for (int nt = 0; nt < HD / 8; nt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vs + key * SROW + nt * 8 + ((mi & 2) ? 8 : 0));
          mma_bf16(o[nt], pa, bv[0], bv[1]);
          mma_bf16(o[nt + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!(i ? vb : va)) continue;
    const size_t base = i ? qb : qa;
    const float inv = 1.f / fmaxf(lrun[i], kMinL);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int c = nt * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(a.out + base + c) =
          __floats2bfloat162_rn(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch(const Params& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  auto kern = flash_prefill_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>(a.tiles) * a.g * a.b;
  kern<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace flash_prefill

extern "C" {

// q (b, n, h, hd), k/v (b, m, g, hd), out (b, n, h, hd), all bf16 and
// contiguous; h a multiple of g; causal 0 or 1; window 0 (none) or > 0, and
// only with causal. Head dims 16, 64, 80 and 128. Returns the CUDA error of
// the launch (0 when it was accepted).
int flash_prefill_attention(const void* q, const void* k, const void* v,
                            void* out, int b, int n, int m, int h, int g,
                            int hd, int q_offset, int window, int causal,
                            float scale, void* stream) {
  using flash_prefill::Params;
  if (b <= 0 || n <= 0 || m <= 0 || g <= 0 || h <= 0 || h % g != 0 ||
      q_offset < 0 || window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.b = b;
  a.n = n;
  a.m = m;
  a.h = h;
  a.g = g;
  a.p = h / g;
  const long long rows = static_cast<long long>(n) * a.p;
  const long long tiles = (rows + bifurcated::kRowTile - 1) / bifurcated::kRowTile;
  if (rows > (1LL << 30) || tiles * g * b > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.rows = static_cast<int>(rows);
  a.tiles = static_cast<int>(tiles);
  a.q_offset = q_offset;
  a.window = window;
  a.causal = causal ? 1 : 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(flash_prefill::launch<16>(a, s));
    case 64: return static_cast<int>(flash_prefill::launch<64>(a, s));
    case 80: return static_cast<int>(flash_prefill::launch<80>(a, s));
    case 128: return static_cast<int>(flash_prefill::launch<128>(a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
