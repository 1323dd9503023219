// Hopper's asynchronous transactions between the blocks of a thread-block
// cluster, as csrc/step_d3q19_blocked.cu uses them (and an L1 prefetch,
// csrc/step_d2q9_blocked.cu's): a transaction barrier
// (mbarrier) in shared memory that counts the bytes other blocks store into
// this block's shared memory (st.async ... mbarrier::complete_tx), and the
// cluster's execution barrier without memory ordering
// (barrier.cluster.arrive.relaxed). PTX ISA 8.x: mbarrier, st.async, mapa,
// barrier.cluster; sm_90.
//
// A block arms its barrier for one phase with the bytes it expects
// (arm_bytes: its own arrival, the barrier's count being 1); each store of
// a neighbour into its shared memory completes 4 of them; wait_phase spins
// until the phase of the given parity has completed, which makes those
// stores visible to the waiting threads. Stores may land before the phase
// is armed (the count of pending bytes goes below zero until it is).
//
// tests/test_torch_mesh_thermal.py holds a host version of this header for
// the fake CUDA runtime the kernels are rehearsed on.

#pragma once

#include <stdint.h>

namespace tpulbm_async {

// The shared-memory address of a generic pointer into this block's shared
// memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A transaction barrier of one arrival (the arming thread's).
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Makes the barriers this block initialised visible to the cluster (before
// a cluster-wide barrier that orders memory).
__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The arming thread's arrival on the current phase, expecting `bytes`.
__device__ __forceinline__ void arm_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Stores v at `at` and completes 4 bytes of the transaction barrier `bar`,
// both in the shared memory of the cluster's block `rank` (`at` and `bar`
// give their places as in this block's shared memory).
__device__ __forceinline__ void store_remote(const float* at,
                                             const uint64_t* bar,
                                             uint32_t rank, float v) {
  uint32_t remote_at, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_at)
               : "r"(smem_addr(at)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_bar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(remote_at),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

// Asks for the line that holds `p` in the SM's L1 (prefetch.global.L1),
// without waiting for it.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The cluster's execution barrier, no memory ordering: every thread of
// every block arrives, then waits for the others.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

}  // namespace tpulbm_async
