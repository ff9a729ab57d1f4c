// LSTM time recurrence, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dotaclient_tpu/ops/lstm.py::_lstm_kernel
// (launched by _pallas_forward, pl.pallas_call at ops/lstm.py:138).
// Computes, for every batch row b and step t (gates i, f, g, o are the
// four H-wide column blocks of z):
//
//     z_t = x_proj[b, t] + rnd(h_{t-1}) @ W_h          (f32 accumulation)
//     c_t = sigmoid(f + 1) * c_{t-1} + sigmoid(i) * tanh(g)
//     h_t = sigmoid(o) * tanh(c_t)
//
// where rnd() rounds h to the compute dtype of W_h (bf16 in the flagship
// policy, identity for f32). Writes h_seq and c_seq [B, T, H] f32 (c_seq
// is what the recompute backward will need) and the final c_T, h_T [B, H].
// Layout is the port's public [B, T, ...]; the TPU kernel's time-major
// transpose is not carried over.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32): at
// the learner's shape B=256, T=17, H=128 the call moves ~9.6 MB in bf16
// (x_proj 4.46 MB in, h_seq + c_seq 2 x 2.23 MB out, W_h and carries
// ~0.7 MB): ~2.9 us at the memory rate, above the ~0.6 us its 0.57 GFLOP
// take on the tensor cores. In f32 the same 0.57 GFLOP on the FMA units
// take ~8.8 us, so there the bound is arithmetic. Either way the 17 steps
// are a dependent chain: every step needs the whole previous h of a row,
// so what a launch costs is mostly 17 x the latency of one step.
//
// Design ("cluster"): a thread-block cluster of C CTAs (C <= 8, portable)
// owns one slab of ROWS = 16 batch rows for all T steps; CTA p of the
// cluster owns the U = H / C hidden units [p*U, (p+1)*U), i.e. the 4*U
// columns {g*H + p*U + u} of W_h (at H=128: C=8, U=16). Against the four
// limits of the first design (one CTA per 1-2 rows, one thread per row
// and unit, a serial 128-long FMA chain per thread):
// 1. No tensor cores -> bf16 runs mma.sync.m16n8k16 (bf16 in, f32
//    accumulate) over the slab's 16 rows; a warp's four n-tiles are gates
//    i, f, g, o of the same 8 units, k is split in four over four warps, and
//    a fixed-order shared-memory sum hands each thread one (row, unit) cell
//    with all four gates. f32 stays on the FMA units (TF32 would change the
//    numerics): a thread computes 8 rows x 4 gates of one unit over every
//    8th k, and a fixed xor reduce-scatter hands each lane its cell.
// 2. Little parallelism per step -> every step of a slab is spread over
//    the C CTAs of 256 threads (at B=256, H=128: 16 clusters x 8 = 128
//    CTAs, each 1/8 of the slab's product).
// 3. f32 W_h (256 KiB) did not fit one block -> each CTA keeps only its
//    H x 4U slice resident (16 KiB bf16, 32 KiB f32 at H=128, C=8).
// 4. W_h copied whole into every CTA -> each CTA copies only its slice,
//    once, with cp.async. x_proj is fetched X_AHEAD steps ahead, each thread
//    for its own cell, so the fetch overlaps the steps before it (a fetch
//    only one step ahead sat on the critical path).
// h is exchanged through distributed shared memory: each thread writes its
// new h, rounded to the compute dtype, into the next h buffer of its own
// CTA and (st.async) of every peer, where it is counted in bytes on the
// peer's mbarrier of that buffer; a step waits on its own CTA's mbarrier
// only. No step runs a cluster barrier, whose release would also wait for
// the step's global stores. A cluster sync after the last step is the exit
// sync: no CTA leaves while a peer may still address its shared memory.
//
// The gate tail is f32 with CUDA's accurate expf, IEEE division and tanhf,
// the functions torch.sigmoid and torch.tanh use on the card.
//
// Row invariance: no sum depends on B or on which rows share a slab (every
// split of k is fixed by H, the partial sums are added in a fixed order, no
// atomics; unused slab rows are zero and their stores masked), so row b of
// any launch is bitwise the same row run alone.
//
// Second design ("per_thread", kept for H not a multiple of 16 or a slice
// too large for shared memory): one CTA per slab of `rows` rows runs the
// whole loop; thread (j, r) owns unit j of row r and computes its four dot
// products serially, W_h in shared memory when it fits, else read from
// global memory through L1/L2.
//
// Geometry (design, cluster, rows, grid, threads, shared memory) is chosen
// in Python (ops/lstm.py::launch_geometry); this file checks it and
// returns cudaErrorInvalidValue for any value it cannot take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 16;               // batch rows per cluster: one m16 tile
constexpr int MAX_CLUSTER = 8;         // portable cluster size
constexpr int CLUSTER_THREADS = 512;   // launch bound of the cluster kernels
constexpr int F32_HS = 20;             // f32 h buffer: floats per k row (16 rows + bank pad)
constexpr int BAR_BYTES = 16;          // the cluster kernels' two mbarriers, first in shared memory
constexpr int KSPLIT = 4;              // bf16: k quarters, one warp each per unit group
constexpr int MAX_KSTEPS = 4;          // bf16: k-steps per warp (H <= 256)
constexpr int X_AHEAD = 3;             // steps between fetching a cell's x_proj and adding it

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// f32 sigmoid and tanh as PyTorch computes them on the card: CUDA's
// accurate expf, IEEE division and tanhf (the build has no fast math).
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float tanh_f32(float x) { return tanhf(x); }

// One cell of the gate tail: updates c and h from the four pre-activations.
__device__ __forceinline__ void gate_tail(float zi, float zf, float zg, float zo, float& c, float& h) {
    const float ig = sigmoid(zi);
    const float fg = sigmoid(zf + 1.0f);
    const float gg = tanh_f32(zg);
    const float og = sigmoid(zo);
    c = fg * c + ig * gg;
    h = og * tanh_f32(c);
}

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}
__device__ __forceinline__ uint32_t cluster_id_x() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
    return r;
}
// Address of the same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t ready;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ready)
        : "r"(bar), "r"(parity)
        : "memory");
    return ready != 0;
}
// Waits for the phase of the given parity to complete. A phase that never
// completes (a byte count that can never be met) traps after ~2^34 cycles
// (seconds), so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    const long long start = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - start > (1ll << 34)) __trap();
}
// 4 bytes into CTA-of-the-cluster shared memory at `addr`, counted on that
// CTA's mbarrier at `bar` (both addresses from map_rank).
__device__ __forceinline__ void st_async_b32(uint32_t addr, uint32_t v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr), "r"(v),
                 "r"(bar)
                 : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators. Registers
// only, so not volatile: the compiler may interleave independent chains.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------- shared by the cluster kernels

// Prologue: this CTA's slice of W_h into ws [H][ldw], in W_h's own layout
// (row k holds W_h[k, g*H + u0 + u] at g*U + u), by cp.async 16 bytes at a
// time (W_h is 16-byte aligned, which the host side checks).
template <typename T>
__device__ __forceinline__ void load_w_slice(T* ws, int ldw, const T* __restrict__ wh, int H, int u0, int U, int tid,
                                             int nthreads) {
    constexpr int PER16 = 16 / sizeof(T);
    const int chunks = U / PER16;
    for (int i = tid; i < H * 4 * chunks; i += nthreads) {
        const int kg = i / chunks, ch = i % chunks;  // kg = 4 * k + gate
        cp_async16(smem_u32(ws + (kg >> 2) * ldw + (kg & 3) * U + ch * PER16),
                   wh + (size_t)(kg >> 2) * 4 * H + (kg & 3) * H + u0 + ch * PER16);
    }
}

// Calls put(r, k, v) with v = h0[b0 + r, k..k+3] for every slab row r (zeros
// for rows past B); float4 loads when h0 is 16-byte aligned.
template <typename Put>
__device__ __forceinline__ void read_h0_slab(const float* __restrict__ h0, int b0, int B, int H, int tid,
                                             int nthreads, Put put) {
    const bool vec = (reinterpret_cast<uintptr_t>(h0) & 15) == 0;
    const int q = H / 4;
#pragma unroll 4
    for (int i = tid; i < ROWS * q; i += nthreads) {
        const int r = i / q, k = (i % q) * 4, b = b0 + r;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b < B) {
            const float* p = h0 + (size_t)b * H + k;
            v = vec ? *reinterpret_cast<const float4*>(p) : make_float4(p[0], p[1], p[2], p[3]);
        }
        put(r, k, v);
    }
}

// x_proj is fetched X_AHEAD steps before the step that adds it, by each
// thread for its own cell only, so no barrier has to publish it and the
// fetch of step t + X_AHEAD overlaps steps t .. t + X_AHEAD - 1.
//
// f32: through a ring of X_AHEAD shared-memory slots [ROWS][4][U] (row r,
// gate g, unit u at (4r + g) * U + u): step t starts the copy of step
// t + X_AHEAD - 1 into the slot step t - 1 used, as one cp.async group per
// thread (4 bytes per gate), and waits for all but the X_AHEAD - 1 newest
// groups.
__device__ __forceinline__ void copy_x_cell(float* xs, const float* __restrict__ xp, bool live, int b, int t,
                                            int T_steps, int H, int u0, int U, int row, int unit) {
    if (live && t < T_steps) {
        const float* src = xp + ((size_t)b * T_steps + t) * 4 * H + u0 + unit;
        float* dst = xs + (t % X_AHEAD) * ROWS * 4 * U + row * 4 * U + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g) cp_async4(smem_u32(dst + g * U), src + g * H);
    }
    cp_async_commit();
}

// bf16: in registers, a ring of X_AHEAD raw slots that the time loop,
// unrolled by X_AHEAD, indexes at compile time; nothing reads a slot between
// its load and its use, so no instruction waits on the load early. (The
// same ring costs f32 more than it saves: its unrolled FMA loop makes the
// thrice-copied step body too large.)
struct XCell {
    bf16 g[4];
};
__device__ __forceinline__ void load_x(XCell& x, const bf16* __restrict__ xp, bool live, int b, int t, int T_steps,
                                       int H, int j) {
    if (live && t < T_steps) {
        const bf16* p = xp + ((size_t)b * T_steps + t) * 4 * H + j;
        x.g[0] = p[0], x.g[1] = p[H], x.g[2] = p[2 * H], x.g[3] = p[3 * H];
    }
}
// Runs step(t, x[t % X_AHEAD]) for t = 0 .. T_steps - 1; slot j first holds
// step j, and `step` reloads its slot with step t + X_AHEAD.
template <typename Step>
__device__ __forceinline__ void run_steps(XCell (&x)[X_AHEAD], int T_steps, Step step) {
    for (int t0 = 0; t0 < T_steps; t0 += X_AHEAD) {
#pragma unroll
        for (int j = 0; j < X_AHEAD; ++j)
            if (t0 + j < T_steps) step(t0 + j, x[j]);
    }
}

// Both cluster kernels keep two mbarriers at the start of shared memory, one
// per h buffer parity. Step t >= 1 waits on mbarrier t & 1, whose phase
// completes when every thread of this CTA has arrived after writing its own
// h_{t-1} cells into the buffer and the peers' h_{t-1} slices (st.async,
// counted in bytes; thread 0's arrival carries the count) have landed. No
// step needs a cluster barrier: a peer can write h_{t+1} into buffer t & 1
// only after it has received this CTA's h_t, which every thread here writes
// after its reads of step t, so one mbarrier per parity also orders the
// reads before the next writes.

// ------------------------------------------------------------------ bf16: tensor cores

// Shared memory: 2 mbarriers | ws [H][4U + 8] bf16 | hs [2][ROWS][H + 8] bf16 |
// red [KSPLIT][ROWS][U + 1] float4. The +8 pads put the 8 rows of every
// ldmatrix on distinct banks; the +1 does the same for the partial sums.
//
// 16U threads = 4 * (U / 8) warps: warp w owns unit group q = w % (U / 8)
// (8 units, all four gates as four n-tiles, so a lane's accumulators hold
// i, f, g, o of the same cells) and k quarter kq = w / (U / 8) (k-steps kq,
// kq + 4, ...). Its W fragments (at most 4 k-steps x 4 n-tiles) are loaded
// into registers once. Each step: 2 ldmatrix + 8 mma.sync per warp at
// H = 128, partial sums to `red`, one CTA barrier, then thread tid adds the
// four quarters of its cell (row tid / U, unit tid % U) in a fixed order
// and runs the cell's gate tail.
__global__ void __launch_bounds__(CLUSTER_THREADS)
    lstm_cluster_mma(const bf16* __restrict__ xp, const bf16* __restrict__ wh, const float* __restrict__ c0,
                     const float* __restrict__ h0, float* __restrict__ hseq, float* __restrict__ cseq,
                     float* __restrict__ cT, float* __restrict__ hT, int B, int T_steps, int H, int C) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int U = H / C, KT = H / 16, NQ = U / 8;
    const int LDW = 4 * U + 8, LDH = H + 8;
    bf16* ws = reinterpret_cast<bf16*>(smem + BAR_BYTES);
    bf16* hs = ws + (size_t)H * LDW;
    float4* red = reinterpret_cast<float4*>(hs + 2 * ROWS * LDH);
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int q = warp % NQ, kq = warp / NQ;
    const int rank = (int)cluster_ctarank();
    const int b0 = (int)cluster_id_x() * ROWS;
    const int u0 = rank * U;
    const uint32_t bar = smem_u32(smem);  // mbarrier of parity p at bar + 8 * p
    const int row = tid / U, unit = tid % U, b = b0 + row;  // this thread's cell
    const bool live = b < B;

    if (tid == 0) {
        mbar_init(bar, nthreads);
        mbar_init(bar + 8, nthreads);
        fence_mbar_init();
    }
    load_w_slice(ws, LDW, wh, H, u0, U, tid, nthreads);
    read_h0_slab(h0, b0, B, H, tid, nthreads, [=](int r, int k, float4 v) {
        *reinterpret_cast<uint2*>(hs + r * LDH + k) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
    });
    float c = live ? c0[(size_t)b * H + u0 + unit] : 0.0f;
    float h = live ? h0[(size_t)b * H + u0 + unit] : 0.0f;
    XCell x[X_AHEAD];
#pragma unroll
    for (int j = 0; j < X_AHEAD; ++j) {
        x[j].g[0] = x[j].g[1] = x[j].g[2] = x[j].g[3] = __float2bfloat16_rn(0.0f);
        load_x(x[j], xp, live, b, j, T_steps, H, u0 + unit);
    }
    cp_async_wait_all();
    cluster_sync();  // every CTA of the cluster runs, with its mbarriers and prologue in place

    // ldmatrix lane addresses. A (h, 16 x 16 per k-step): matrices (rows 0-7 |
    // 8-15) x (k 0-7 | 8-15). B (W slice, k-major, read transposed): matrices
    // (k 0-7 | 8-15) x (first | second n-tile of a gate pair) of unit group q.
    const uint32_t hs_addr = smem_u32(hs), ws_addr = smem_u32(ws);
    const uint32_t a_lane = ((((lane >> 3) & 1) * 8 + (lane & 7)) * LDH + (lane >> 4) * 8) * 2;
    const uint32_t b_lane = ((((lane >> 3) & 1) * 8 + (lane & 7)) * LDW + (lane >> 4) * U + q * 8) * 2;
    const uint32_t b_pair = 2 * U * 2;  // gates (2, 3) sit 2U columns after gates (0, 1)
    uint32_t bw[MAX_KSTEPS][4][2];
#pragma unroll
    for (int j = 0; j < MAX_KSTEPS; ++j) {
        const int kt = kq + KSPLIT * j;
        if (kt < KT) {
            uint32_t f[4];
            ldmatrix_x4_trans(f, ws_addr + b_lane + kt * 16 * LDW * 2);
            bw[j][0][0] = f[0], bw[j][0][1] = f[1], bw[j][1][0] = f[2], bw[j][1][1] = f[3];
            ldmatrix_x4_trans(f, ws_addr + b_lane + kt * 16 * LDW * 2 + b_pair);
            bw[j][2][0] = f[0], bw[j][2][1] = f[1], bw[j][3][0] = f[2], bw[j][3][1] = f[3];
        }
    }
    uint32_t peer_hs[MAX_CLUSTER], peer_bar[MAX_CLUSTER];  // the same offsets in every CTA of the cluster
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p)
        if (p < C) peer_hs[p] = map_rank(hs_addr, p), peer_bar[p] = map_rank(bar, p);
    const uint32_t tx_bytes = (C - 1) * ROWS * U * 2;                    // the peers' h slices per step
    const int cell_a = (lane >> 2) * (U + 1) + q * 8 + 2 * (lane & 3);  // red index of accumulator rows gid, gid + 8
    const uint32_t h_off = (row * LDH + u0 + unit) * 2;                 // this cell in an h buffer, bytes

    run_steps(x, T_steps, [&](int t, XCell& xt) {
        const int cur = t & 1, nxt = cur ^ 1;
        if (t > 0) mbar_wait(bar + 8 * cur, ((t - 1) >> 1) & 1);

        float acc[4][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.0f;
        const uint32_t a_base = hs_addr + cur * ROWS * LDH * 2 + a_lane;
#pragma unroll
        for (int j = 0; j < MAX_KSTEPS; ++j) {
            const int kt = kq + KSPLIT * j;
            if (kt < KT) {
                uint32_t a[4];
                ldmatrix_x4(a, a_base + kt * 32);
#pragma unroll
                for (int g = 0; g < 4; ++g) mma_bf16(acc[g], a, bw[j][g][0], bw[j][g][1]);
            }
        }
        float4* rq = red + kq * ROWS * (U + 1) + cell_a;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            rq[(e >> 1) * 8 * (U + 1) + (e & 1)] = make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
        __syncthreads();

        // the four k quarters of this cell, ((q0 + q1) + (q2 + q3)) in every row
        const float4* rc = red + row * (U + 1) + unit;
        const int qs = ROWS * (U + 1);
        const float4 s0 = rc[0], s1 = rc[qs], s2 = rc[2 * qs], s3 = rc[3 * qs];
        gate_tail(to_f32(xt.g[0]) + ((s0.x + s1.x) + (s2.x + s3.x)), to_f32(xt.g[1]) + ((s0.y + s1.y) + (s2.y + s3.y)),
                  to_f32(xt.g[2]) + ((s0.z + s1.z) + (s2.z + s3.z)),
                  to_f32(xt.g[3]) + ((s0.w + s1.w) + (s2.w + s3.w)), c, h);
        load_x(xt, xp, live, b, t + X_AHEAD, T_steps, H, u0 + unit);
        if (live) {
            const size_t o = ((size_t)b * T_steps + t) * H + u0 + unit;
            hseq[o] = h;
            cseq[o] = c;
        }
        if (t + 1 < T_steps) {  // rnd(h) into the next h buffer of every CTA of the cluster
            const float h_odd = __shfl_down_sync(0xffffffffu, h, 1);
            if ((unit & 1) == 0) {  // the even unit's lane stores the pair
                const uint32_t v = pack_bf16x2(h, h_odd), off = nxt * ROWS * LDH * 2 + h_off;
#pragma unroll
                for (int p = 0; p < MAX_CLUSTER; ++p)
                    if (p < C) {
                        if (p == rank)
                            *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(hs) + off) = v;
                        else
                            st_async_b32(peer_hs[p] + off, v, peer_bar[p] + 8 * nxt);
                    }
            }
            if (tid == 0)
                mbar_arrive_expect_tx(bar + 8 * nxt, tx_bytes);
            else
                mbar_arrive(bar + 8 * nxt);
        }
    });
    cluster_sync();  // exit: no CTA leaves while a peer may still address its shared memory
    if (live) {
        cT[(size_t)b * H + u0 + unit] = c;
        hT[(size_t)b * H + u0 + unit] = h;
    }
}

// -------------------------------------------------------------------- f32: FMA units

// Shared memory: 2 mbarriers | ws [H][4U + 4] f32 | hs [2][H][F32_HS] f32
// (k-major, the 16 rows contiguous) | xs [X_AHEAD][ROWS][4][U] f32. The pads
// put the 8 k rows that a warp reads at once on distinct banks.
//
// 16U threads: thread (warp, lane) has row group rg = warp % 2 (rows
// 8rg..8rg+7), unit u = (warp / 2) * 4 + lane / 8 and k lane ks = lane % 8
// (k = ks, ks + 8, ...). It computes 8 rows x 4 gates of unit u over its k:
// per k, two float4 of h and 4 floats of W for 32 FMAs. A reduce-scatter
// over the 8 k lanes (xor 4, 2, 1: the same tree for every row) then leaves
// lane ks with the four gates of row 8rg + ks, the cell it owns.
__global__ void __launch_bounds__(CLUSTER_THREADS)
    lstm_cluster_ffma(const float* __restrict__ xp, const float* __restrict__ wh, const float* __restrict__ c0,
                      const float* __restrict__ h0, float* __restrict__ hseq, float* __restrict__ cseq,
                      float* __restrict__ cT, float* __restrict__ hT, int B, int T_steps, int H, int C) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int U = H / C;
    const int LDW = 4 * U + 4;
    float* ws = reinterpret_cast<float*>(smem + BAR_BYTES);
    float* hs = ws + (size_t)H * LDW;
    float* xs = hs + 2 * H * F32_HS;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int rank = (int)cluster_ctarank();
    const int b0 = (int)cluster_id_x() * ROWS;
    const int u0 = rank * U;
    const uint32_t bar = smem_u32(smem);
    const int ks = lane & 7, rg = warp & 1, u = (warp >> 1) * 4 + (lane >> 3);
    const int row = rg * 8 + ks, b = b0 + row;  // this thread's cell
    const bool live = b < B;

    if (tid == 0) {
        mbar_init(bar, nthreads);
        mbar_init(bar + 8, nthreads);
        fence_mbar_init();
    }
    load_w_slice(ws, LDW, wh, H, u0, U, tid, nthreads);
    read_h0_slab(h0, b0, B, H, tid, nthreads, [=](int r, int k, float4 v) {
        hs[k * F32_HS + r] = v.x;
        hs[(k + 1) * F32_HS + r] = v.y;
        hs[(k + 2) * F32_HS + r] = v.z;
        hs[(k + 3) * F32_HS + r] = v.w;
    });
    float c = live ? c0[(size_t)b * H + u0 + u] : 0.0f;
    float h = live ? h0[(size_t)b * H + u0 + u] : 0.0f;
    cp_async_commit();
    for (int i = tid; i < X_AHEAD * ROWS * 4 * U; i += nthreads) xs[i] = 0.0f;  // rows past B
    cp_async_wait_all();
    __syncthreads();
    for (int j = 0; j + 1 < X_AHEAD; ++j) copy_x_cell(xs, xp, live, b, j, T_steps, H, u0, U, row, u);
    cluster_sync();  // every CTA of the cluster runs, with its mbarriers and prologue in place

    uint32_t peer_hs[MAX_CLUSTER], peer_bar[MAX_CLUSTER];  // the same offsets in every CTA of the cluster
    const uint32_t hs_addr = smem_u32(hs);
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p)
        if (p < C) peer_hs[p] = map_rank(hs_addr, p), peer_bar[p] = map_rank(bar, p);
    const uint32_t tx_bytes = (C - 1) * ROWS * U * 4;  // the peers' h slices per step
    const bool b2 = ks & 4, b1 = ks & 2, b0_ = ks & 1;

    for (int t = 0; t < T_steps; ++t) {
        const int cur = t & 1, nxt = cur ^ 1;
        if (t > 0) mbar_wait(bar + 8 * cur, ((t - 1) >> 1) & 1);
        copy_x_cell(xs, xp, live, b, t + X_AHEAD - 1, T_steps, H, u0, U, row, u);

        float acc[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
        const float* hp = hs + cur * H * F32_HS + rg * 8;
        const float* wp = ws + u;
#pragma unroll 2
        for (int k = ks; k < H; k += 8) {
            const float4 ha = *reinterpret_cast<const float4*>(hp + k * F32_HS);
            const float4 hb = *reinterpret_cast<const float4*>(hp + k * F32_HS + 4);
            const float* wk = wp + k * LDW;
            const float hr[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
            const float wg[4] = {wk[0], wk[U], wk[2 * U], wk[3 * U]};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hr[r], wg[g], acc[r][g]);
        }
        // reduce-scatter over the 8 k lanes: at each level a lane keeps half
        // of its rows and adds the partner's sums for them
        float l1[4][4], l2[2][4], z[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int g = 0; g < 4; ++g)
                l1[r][g] = (b2 ? acc[r + 4][g] : acc[r][g]) +
                           __shfl_xor_sync(0xffffffffu, b2 ? acc[r][g] : acc[r + 4][g], 4);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int g = 0; g < 4; ++g)
                l2[r][g] = (b1 ? l1[r + 2][g] : l1[r][g]) +
                           __shfl_xor_sync(0xffffffffu, b1 ? l1[r][g] : l1[r + 2][g], 2);
#pragma unroll
        for (int g = 0; g < 4; ++g)
            z[g] = (b0_ ? l2[1][g] : l2[0][g]) + __shfl_xor_sync(0xffffffffu, b0_ ? l2[0][g] : l2[1][g], 1);

        cp_async_wait_group<X_AHEAD - 1>();  // this thread's x_proj of step t
        const float* xr = xs + (t % X_AHEAD) * ROWS * 4 * U + row * 4 * U + u;
        gate_tail(xr[0] + z[0], xr[U] + z[1], xr[2 * U] + z[2], xr[3 * U] + z[3], c, h);
        if (live) {
            const size_t o = ((size_t)b * T_steps + t) * H + u0 + u;
            hseq[o] = h;
            cseq[o] = c;
        }
        if (t + 1 < T_steps) {  // h into the next h buffer of every CTA of the cluster
            const uint32_t off = ((nxt * H + u0 + u) * F32_HS + row) * 4, hv = __float_as_uint(h);
#pragma unroll
            for (int p = 0; p < MAX_CLUSTER; ++p)
                if (p < C) {
                    if (p == rank)
                        hs[off / 4] = h;
                    else
                        st_async_b32(peer_hs[p] + off, hv, peer_bar[p] + 8 * nxt);
                }
            if (tid == 0)
                mbar_arrive_expect_tx(bar + 8 * nxt, tx_bytes);
            else
                mbar_arrive(bar + 8 * nxt);
        }
    }
    cluster_sync();  // exit: no CTA leaves while a peer may still address its shared memory
    if (live) {
        cT[(size_t)b * H + u0 + u] = c;
        hT[(size_t)b * H + u0 + u] = h;
    }
}

// ------------------------------------------------------------ second design: per thread

template <typename T, bool W_SMEM>
__global__ void lstm_per_thread(const T* __restrict__ xp, const T* __restrict__ wh, const float* __restrict__ c0,
                                const float* __restrict__ h0, float* __restrict__ hseq, float* __restrict__ cseq,
                                float* __restrict__ cT, float* __restrict__ hT, int B, int T_steps, int H) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H4 = 4 * H;
    const int R = blockDim.y;
    const int j = threadIdx.x;
    const int r = threadIdx.y;
    const int b = blockIdx.x * R + r;
    const bool live = b < B;
    const size_t w_bytes = W_SMEM ? (size_t)H * H4 * sizeof(T) : 0;
    T* h_s = reinterpret_cast<T*>(smem + w_bytes);  // [2][R][H]

    const T* w = wh;
    if (W_SMEM) {
        T* w_s = reinterpret_cast<T*>(smem);
        const int tid = r * H + j;
        const int nthreads = R * H;
        // 16-byte vector copy when W_h is 16-byte aligned, scalar tail/else
        const size_t n16 = (reinterpret_cast<uintptr_t>(wh) % 16 == 0) ? w_bytes / 16 : 0;
        const int4* src = reinterpret_cast<const int4*>(wh);
        int4* dst = reinterpret_cast<int4*>(w_s);
        for (size_t i = tid; i < n16; i += nthreads) dst[i] = src[i];
        const size_t n = (size_t)H * H4;
        for (size_t i = n16 * 16 / sizeof(T) + tid; i < n; i += nthreads) w_s[i] = wh[i];
        w = w_s;
    }

    float c = live ? c0[(size_t)b * H + j] : 0.0f;
    float h = live ? h0[(size_t)b * H + j] : 0.0f;
    h_s[r * H + j] = from_f32<T>(h);
    __syncthreads();

    for (int t = 0; t < T_steps; ++t) {
        float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
        if (live) {
            const T* xr = xp + ((size_t)b * T_steps + t) * H4;
            x0 = to_f32(xr[j]);
            x1 = to_f32(xr[H + j]);
            x2 = to_f32(xr[2 * H + j]);
            x3 = to_f32(xr[3 * H + j]);
        }
        const T* hp = h_s + (t & 1) * R * H + r * H;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
            const float hk = to_f32(hp[k]);
            const T* wr = w + (size_t)k * H4 + j;
            a0 = fmaf(hk, to_f32(wr[0]), a0);
            a1 = fmaf(hk, to_f32(wr[H]), a1);
            a2 = fmaf(hk, to_f32(wr[2 * H]), a2);
            a3 = fmaf(hk, to_f32(wr[3 * H]), a3);
        }
        gate_tail(x0 + a0, x1 + a1, x2 + a2, x3 + a3, c, h);
        if (live) {
            const size_t o = ((size_t)b * T_steps + t) * H + j;
            hseq[o] = h;
            cseq[o] = c;
        }
        h_s[((t + 1) & 1) * R * H + r * H + j] = from_f32<T>(h);
        __syncthreads();
    }
    if (live) {
        cT[(size_t)b * H + j] = c;
        hT[(size_t)b * H + j] = h;
    }
}

// ---------------------------------------------------------------------- host side

// Shared memory of the cluster kernels; ops/lstm.py::_cluster_smem_bytes
// computes the same.
size_t cluster_smem_bytes(int H, int U, size_t elt) {
    const size_t w = (size_t)H * (4 * U + (elt == 2 ? 8 : 4)) * elt;
    const size_t h = elt == 2 ? (size_t)2 * ROWS * (H + 8) * 2 : (size_t)2 * H * F32_HS * 4;
    const size_t x = elt == 2 ? (size_t)KSPLIT * ROWS * (U + 1) * 16 : (size_t)X_AHEAD * ROWS * 4 * U * 4;
    return BAR_BYTES + w + h + x;
}

struct Placed {
    const void* fn;
    int dev, cluster, threads;
    size_t smem;
    bool operator==(const Placed& o) const {
        return fn == o.fn && dev == o.dev && cluster == o.cluster && threads == o.threads && smem == o.smem;
    }
};
std::mutex g_placed_mu;
std::vector<Placed> g_placed;     // cluster launches already checked for placement
std::vector<Placed> g_smem_limit;  // per (kernel, device): the shared-memory limit set so far
thread_local Placed t_last_placed = {nullptr, -1, 0, 0, 0};  // this thread's last checked launch

// A launch of `grid` CTAs in clusters of `cluster` along x; `attr` must
// outlive the returned config.
cudaLaunchConfig_t cluster_config(int grid, int cluster, int threads, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute& attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Once per (kernel, device, geometry): raise the kernel's shared-memory
// limit if needed (never lower it: an earlier geometry may need more;
// CUDA refuses a limit over the card's opt-in) and check that at least
// one cluster of this shape fits on the card. A repeat of the calling
// thread's last checked launch returns at once, without the lock.
template <typename... Args>
cudaError_t check_cluster_placement(void (*kernel)(Args...), int dev, int cluster, int threads, size_t smem) {
    const Placed want = {reinterpret_cast<const void*>(kernel), dev, cluster, threads, smem};
    if (t_last_placed == want) return cudaSuccess;
    std::lock_guard<std::mutex> lock(g_placed_mu);
    for (const Placed& p : g_placed)
        if (p == want) {
            t_last_placed = want;
            return cudaSuccess;
        }
    int can = 0;
    cudaError_t e = cudaDeviceGetAttribute(&can, cudaDevAttrClusterLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!can) return cudaErrorNotSupported;
    Placed* limit = nullptr;
    for (Placed& p : g_smem_limit)
        if (p.fn == want.fn && p.dev == dev) limit = &p;
    if (limit == nullptr || limit->smem < smem) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        if (limit == nullptr)
            g_smem_limit.push_back({want.fn, dev, 0, 0, smem});
        else
            limit->smem = smem;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, threads, smem, nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidConfiguration;  // the cluster cannot be placed
    g_placed.push_back(want);
    t_last_placed = want;
    return cudaSuccess;
}

template <typename T>
cudaError_t launch_cluster(void (*kernel)(const T*, const T*, const float*, const float*, float*, float*, float*,
                                          float*, int, int, int, int),
                           const void* xp, const void* wh, const void* c0, const void* h0, void* hseq, void* cseq,
                           void* cT, void* hT, int B, int T_steps, int H, int cluster, int grid, int threads,
                           size_t smem, cudaStream_t stream) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = check_cluster_placement(kernel, dev, cluster, threads, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(grid, cluster, threads, smem, stream, attr);
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(xp), static_cast<const T*>(wh),
                           static_cast<const float*>(c0), static_cast<const float*>(h0), static_cast<float*>(hseq),
                           static_cast<float*>(cseq), static_cast<float*>(cT), static_cast<float*>(hT), B, T_steps,
                           H, cluster);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

template <typename T, bool W_SMEM>
cudaError_t launch_per_thread(const void* xp, const void* wh, const void* c0, const void* h0, void* hseq,
                              void* cseq, void* cT, void* hT, int B, int T_steps, int H, int rows, int grid,
                              size_t smem, cudaStream_t stream) {
    auto kernel = lstm_per_thread<T, W_SMEM>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<dim3(grid), dim3(H, rows), smem, stream>>>(
        static_cast<const T*>(xp), static_cast<const T*>(wh), static_cast<const float*>(c0),
        static_cast<const float*>(h0), static_cast<float*>(hseq), static_cast<float*>(cseq),
        static_cast<float*>(cT), static_cast<float*>(hT), B, T_steps, H);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The current device's SM count, opt-in shared memory per block and
// whether it launches clusters: what ops/lstm.py::launch_geometry needs.
int lstm_recurrence_device_limits(int* n_sm, int* smem_optin, int* cluster_launch) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(cluster_launch, cudaDevAttrClusterLaunch, dev);
    return (int)e;
}

// dtype: 0 = float32, 1 = bfloat16 (x_proj and w_h share it). design:
// 0 = per thread (`rows` rows per CTA, no cluster), 1 = cluster (ROWS rows
// per cluster of `cluster` CTAs; tensor cores in bf16, FMA units in f32).
// Returns a cudaError_t: 0 on a successful launch, cudaErrorInvalidValue
// for a geometry this file cannot take. Launches on `stream`, does not
// synchronise and allocates nothing.
int lstm_recurrence_fwd(const void* xp, const void* wh, const void* c0, const void* h0, void* hseq, void* cseq,
                        void* cT, void* hT, int B, int T_steps, int H, int dtype, int design, int cluster, int rows,
                        int grid, int threads, int smem, void* stream) {
    if (B <= 0 || T_steps < 0 || H <= 0 || H > 1024 || (dtype != 0 && dtype != 1) || rows <= 0 || grid <= 0 ||
        threads <= 0 || smem < 0)
        return (int)cudaErrorInvalidValue;
    const size_t elt = dtype == 1 ? 2 : 4;
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    if (design == 1) {
        if (cluster < 1 || cluster > MAX_CLUSTER || H % (16 * cluster) != 0 || rows != ROWS) return (int)cudaErrorInvalidValue;
        const int U = H / cluster;
        const int want_threads = 16 * U;
        if (threads != want_threads || threads > CLUSTER_THREADS || (size_t)smem != cluster_smem_bytes(H, U, elt) ||
            (long long)grid != (long long)((B + ROWS - 1) / ROWS) * cluster ||
            (reinterpret_cast<uintptr_t>(wh) & 15) != 0)
            return (int)cudaErrorInvalidValue;
        if (dtype == 1)
            return (int)launch_cluster<bf16>(lstm_cluster_mma, xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H,
                                             cluster, grid, threads, smem, s);
        return (int)launch_cluster<float>(lstm_cluster_ffma, xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H,
                                          cluster, grid, threads, smem, s);
    }
    if (design != 0 || cluster != 1 || rows * H > 1024 || threads != rows * H || grid != (B + rows - 1) / rows)
        return (int)cudaErrorInvalidValue;
    const size_t h_bytes = 2 * (size_t)rows * H * elt;
    const size_t w_bytes = (size_t)H * 4 * H * elt;
    bool w_smem;
    if ((size_t)smem == w_bytes + h_bytes)
        w_smem = true;
    else if ((size_t)smem == h_bytes)
        w_smem = false;
    else
        return (int)cudaErrorInvalidValue;
    if (dtype == 1)
        return (int)(w_smem ? launch_per_thread<bf16, true>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, grid, smem, s)
                            : launch_per_thread<bf16, false>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, grid, smem, s));
    return (int)(w_smem ? launch_per_thread<float, true>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, grid, smem, s)
                        : launch_per_thread<float, false>(xp, wh, c0, h0, hseq, cseq, cT, hT, B, T_steps, H, rows, grid, smem, s));
}

const char* lstm_recurrence_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
