// Shared device definitions for the port's kernels.
//
// The fixed reduction order of a square-difference sum over d: d is padded
// with zeros to a multiple of 32, lane sum l takes the elements l, l+32,
// l+64, ... in sequence, then an xor butterfly over offsets 16, 8, 4, 2, 1
// combines the 32 lane sums.  The kernels keep the 32 lane sums of one
// candidate in one thread's registers and evaluate the butterfly as a tree
// (s[l] + s[l + 16], then + 8, 4, 2, 1), which is lane 0's order and, since
// each add is commutative, every lane's.  Every add and multiply is an
// explicitly rounded intrinsic, so nvcc cannot contract them into FMAs.
// The plain PyTorch versions (kernels/expand_score.py::sq_dist_fixed_order)
// reproduce this order exactly, which is what makes kernel and plain
// version bitwise equal on any float input.
#pragma once

#include <cuda_runtime.h>

#define REPRO_FULL_MASK 0xffffffffu
