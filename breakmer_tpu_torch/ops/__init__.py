"""Device ops: the k-mer engine (plain torch ops) and the wavefront
Smith-Waterman (plain torch version in ops.sw, hand-written CUDA kernel
behind ops.sw_cuda)."""
