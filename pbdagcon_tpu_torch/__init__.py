"""pbdagcon_tpu_torch: the PyTorch + CUDA port of tpu-dagcon.

It sits beside the JAX package `pbdagcon_tpu`, which stays the
reference. The port imports torch and never jax. Framework-free modules
of the JAX package are shared by import, not copied: the alignment
records and parsers, the IO, the graph oracle, the host linearizer, the
`-a` aligner, the simulator and the native C++ engine's bindings.

Layer map (this slice: the native-loader consensus path):

- `config`    : `DagconConfig` (backends "cuda", "host", "auto").
- `pipeline`  : stream -> native linearize -> batched DP -> native
                backtrack + FASTA (`run_stream`).
- `native`    : the batch packer over the native engine's C ABI.
- `ops.dp`    : the DP's dispatcher, its plain PyTorch version and the
                batch layout helpers.
- `ops.dp_cuda` + `csrc/dp_scan.cu`: the hand-written Hopper DP kernel.
- `convert`   : config and packed batches from the JAX package.
- `parallel`  : the completed-target journal.
- `cli`       : `python -m pbdagcon_tpu_torch`.
"""

__version__ = "0.1.0"

from pbdagcon_tpu.alignment import (  # noqa: F401
    Alignment,
    normalize_gaps,
    parse_m5,
    parse_pre,
    trim_aln,
)
from pbdagcon_tpu.io import FastaWriter  # noqa: F401
from pbdagcon_tpu.simulate import (  # noqa: F401
    NoiseProfile,
    simulate_targets,
    to_m5,
    to_pre_raw,
)
from pbdagcon_tpu_torch.config import DagconConfig  # noqa: F401
