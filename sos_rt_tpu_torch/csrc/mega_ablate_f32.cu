// The ablated builds of the resident kernel (mega_ablate.cuh) in float32 'highest'.
#define ABLATE_T float
#define ABLATE_MODE MM_HIGHEST
#include "mega_ablate.cuh"
