"""Host operators and the streamed kernels of the port."""
