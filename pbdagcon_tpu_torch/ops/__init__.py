"""Tensor path of the port: the batched consensus DP (`dp.py`), the
device graph build (`devbuild_torch.py`), the device backtrack
(`devemit.py`), the histogram/scatter/gather wrappers (`mxu.py`), the
kernel-variant microbench's histograms and scatter (`pk.py`), the
device aligner (`align_tpu.py`), the hand-written CUDA kernels
(`csrc/dp_scan.cu` via `dp_cuda.py`, `csrc/hist_scatter.cu` via
`mxu_cuda.py`, `csrc/pk_variants.cu` via `pk_cuda.py`,
`csrc/align_scan.cu` via `align_cuda.py`), the nvcc build and loader
(`_build.py`), and the port's
copies of the host linearizer (`linearize.py`) and of the device
build's encoder and constants (`devbuild.py`)."""
