#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { shim_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group{}; }
// compiled, never run (the shim launches no cluster)
struct cluster_group {
  unsigned block_rank() { std::abort(); }
  template <typename T>
  T* map_shared_rank(T*, int) { std::abort(); }
  void sync() { std::abort(); }
};
inline cluster_group this_cluster() { std::abort(); }
}  // namespace cooperative_groups
