// How the fused pass K1 (megakernel.cu) and its forward mode K2
// (megakernel_jvp.cu) cover their lanes' samples when a thread a lane would
// leave the card idle; ops/megakernel.py:sample_plan computes the same.
//
// A lane's eff samples split into blocks of per_block consecutive samples
// (1, or eff: one thread a lane), one thread a block. Both kernels must keep
// K1's sums to the bit, and K1 adds every radiance term of a lane, sample
// after sample, to one running sum. So a lane's first block keeps that sum
// itself, every later block logs the values of its terms (at most
// 2 max_depth + 1 a sample: max_depth + 1 vertices, each an NEE sum and an
// emission term, except that the last neither scatters nor, if it missed,
// emits) to shared memory, and after a barrier one thread per (lane,
// channel) continues the first block's sum over the later blocks' logs in
// (sample, term) order. A CTA holds lanes_per_cta lanes and `wave` blocks of
// each at a time; a lane with more blocks than a CTA holds goes through in
// waves, its running sums carried over in shared memory.
//
// The kernels differ in what a thread and a lane keep besides the log (the
// shared-byte rule): K2 a thread's value and tangent sums and its term count
// (7 floats) and a lane's running value and tangent sums (6); K1 a thread's
// value sum and count (4) and a lane's running sum (3). And each has its own
// threshold of lanes below which it takes a thread a sample.

#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace sample_plan {

constexpr int kMaxThreads = 128;         // a CTA
constexpr size_t kSharedLimit = 232448;  // bytes of shared memory a CTA may use (227 KB)

struct Plan {
  int per_block;      // samples a thread walks in series: 1, or eff
  int blocks;         // eff / per_block blocks a lane
  int log_terms;      // terms a block can log: 2 max_depth + 1; 0 for one block a lane
  int threads;        // = lanes_per_cta * wave; 0 where not even one thread's log fits
  int lanes_per_cta;
  int wave;           // blocks of a lane walked at once
  int waves;          // ceil(blocks / wave)
  int shared;         // bytes
};

// One thread a sample below `resident` lanes, else one thread a lane (no
// log); as many threads a CTA as fit in kMaxThreads and its shared memory
// (whole warps where at least one fits), all of a lane's blocks in one wave
// where they fit, else in equal waves of one lane. A thread keeps its log of
// 3 x log_terms floats and `thread_floats` more; a lane `lane_floats`.
__host__ inline Plan plan(int n_lanes, int eff, int max_depth, int resident, int thread_floats, int lane_floats) {
  Plan q;
  q.threads = 0;
  if (n_lanes < 1 || eff < 1) return q;
  q.per_block = n_lanes < resident ? 1 : eff;
  q.blocks = eff / q.per_block;
  const size_t terms = q.blocks > 1 ? 2 * static_cast<size_t>(max_depth > 0 ? max_depth : 0) + 1 : 0;
  size_t cap = kSharedLimit / ((3 * terms + thread_floats + lane_floats) * sizeof(float));
  if (cap > kMaxThreads) cap = kMaxThreads;
  if (cap >= 32) cap = cap / 32 * 32;
  if (cap < 1) return q;
  q.log_terms = static_cast<int>(terms);
  const int c = static_cast<int>(cap);
  if (q.blocks <= c) {
    q.wave = q.blocks;
    q.lanes_per_cta = c / q.blocks;
    q.waves = 1;
  } else {
    q.waves = (q.blocks + c - 1) / c;
    q.wave = (q.blocks + q.waves - 1) / q.waves;
    q.lanes_per_cta = 1;
  }
  q.threads = q.lanes_per_cta * q.wave;
  q.shared = static_cast<int>((q.threads * (3 * terms + thread_floats) + lane_floats * static_cast<size_t>(q.lanes_per_cta)) *
                              sizeof(float));
  return q;
}

// A kernel's plan constants in the order ops/megakernel.py mirrors them:
// kMaxThreads, kSharedLimit, its threshold, its thread and lane floats.
__host__ inline void constants(int* out, int resident, int thread_floats, int lane_floats) {
  out[0] = kMaxThreads;
  out[1] = static_cast<int>(kSharedLimit);
  out[2] = resident;
  out[3] = thread_floats;
  out[4] = lane_floats;
}

}  // namespace sample_plan
