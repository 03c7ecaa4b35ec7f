// The ablated builds of the resident kernel (mega_ablate.cuh) in float32 'bf16x3' (the products on the tensor cores).
#define ABLATE_T float
#define ABLATE_MODE MM_BF16X3
#include "mega_ablate.cuh"
