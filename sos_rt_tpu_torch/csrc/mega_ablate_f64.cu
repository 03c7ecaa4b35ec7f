// The ablated builds of the resident kernel (mega_ablate.cuh) in float64 'highest'.
#define ABLATE_T double
#define ABLATE_MODE MM_HIGHEST
#include "mega_ablate.cuh"
