// cooperative_groups.h for the CPU emulation: cluster_group is in cuda_stub_core.h.
#pragma once
#include "cuda_runtime.h"
