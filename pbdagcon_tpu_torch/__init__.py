"""pbdagcon_tpu_torch: the PyTorch + CUDA port of tpu-dagcon.

It sits beside the JAX package `pbdagcon_tpu`, which stays the
reference. The port imports torch and never jax, and nothing of the JAX
package either: it keeps its own copies, under the same module names,
of the framework-free modules it uses (the alignment records and
parsers, the IO, the graph oracle, the host linearizer, the `-a`
aligner, the simulator, the self-check, the native C++ engine's
bindings, the device build's encoder and the devbuild shape ladders,
hgap and the DAZZ_DB reader).
The tests hold each copy against its original.

Layer map (slices: the native-loader consensus path, the devbuild path,
the kernel-variant microbench, the device aligner, the frontends, the
hybrid scheduler):

- `config`    : `DagconConfig` (backends "cuda", "blocked", "devbuild",
                "hybrid", "host", "auto": hybrid on a card with the
                native engine, else cuda; aligners "host", "device").
- `pipeline`  : stream -> native linearize -> batched DP -> native
                backtrack + FASTA (`run_stream`), the device
                re-alignment (`device_align_stream`), and the devbuild
                and hybrid dispatch.
- `hybrid`    : the native engine and devbuild side by side on
                group-aligned chunks (`run_stream_hybrid`).
- `devpipe`   : stream -> native encode -> device build + DP + device
                backtrack -> host fragment assembly + FASTA.
- `native`    : the batch packer and the encoded-input fill over the
                native engine's C ABI, into pinned memory.
- `ops.dp`    : the DP's dispatcher, its plain PyTorch version and the
                batch layout helpers.
- `ops.dp_cuda` + `csrc/dp_scan.cu`: the hand-written Hopper DP kernel.
- `ops.devbuild_torch`, `ops.devemit`: the device graph build and
                backtrack.
- `ops.mxu`   : histogram/scatter dispatchers with their plain versions,
                and the clamped gathers.
- `ops.mxu_cuda` + `csrc/hist_scatter.cu`: the hand-written Hopper
                histogram and scatter kernels.
- `ops.pk`, `ops.pk_cuda` + `csrc/pk_variants.cu`: three other designs
                of them (tensor-core one-hots, a row per block,
                shared-memory D tiles).
- `ops.align_tpu`, `ops.align_cuda` + `csrc/align_scan.cu`: the
                batched banded aligner (kernel X1) and its plain
                versions.
- `hgap`, `dazzio`, `dazcon`: the M4 + FASTA and DAZZ_DB/.las frontends
                (`python -m pbdagcon_tpu_torch.hgap`, `.dazcon`).
- `tools.prof_pk`: the kernel-variant microbench
                (`python -m pbdagcon_tpu_torch.tools.prof_pk`).
- `convert`   : config, packed batches and device-build arrays from the
                JAX package.
- `alignment`, `io`, `oracle`, `ops.linearize`, `aligner`, `simulate`,
  `selfcheck`, `ops.devbuild`, `hgap`, `dazzio`: the copies of the
  framework-free modules.
- `parallel`  : the completed-target journal.
- `cli`       : `python -m pbdagcon_tpu_torch`.
"""

__version__ = "0.1.0"

from pbdagcon_tpu_torch.alignment import (  # noqa: F401
    Alignment,
    normalize_gaps,
    parse_m5,
    parse_pre,
    trim_aln,
)
from pbdagcon_tpu_torch.io import FastaWriter  # noqa: F401
from pbdagcon_tpu_torch.simulate import (  # noqa: F401
    NoiseProfile,
    simulate_targets,
    to_m5,
    to_pre_raw,
)
from pbdagcon_tpu_torch.config import DagconConfig  # noqa: F401
