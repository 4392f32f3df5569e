// Distributed shared memory and the split cluster barrier (sm_90),
// shared by the kernels that run one thread-block cluster a batch
// element and read a neighbouring CTA's band of a plane in place
// (xy_segment.cu, xy_bezier_segment.cu).
#pragma once

#include <cuda_runtime.h>

// a shared::cta address of this CTA as a shared::cluster address of CTA
// `rank` of the cluster (the same offset in that CTA's shared memory)
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ double ld_cluster(unsigned addr, double) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];"
               : "=d"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster(unsigned addr, float) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// the cluster barrier in two halves, each thread on its own (not
// .aligned: the warps arrive from divergent code); arrive releases and
// wait acquires the shared and global memory writes before it
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
