// math_constants.h for the CPU emulation: CUDART_INF_F is in cuda_stub_core.h.
#pragma once
