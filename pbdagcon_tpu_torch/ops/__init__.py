"""Tensor path of the port: the batched consensus DP (`dp.py`), its
hand-written CUDA kernel (`dp_cuda.py`, `csrc/dp_scan.cu`) and the nvcc
build and loader (`_build.py`). The host linearizer is shared with the
JAX package (`pbdagcon_tpu.ops.linearize`)."""
