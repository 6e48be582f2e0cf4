"""mixed_flash_roofline (%): the flash-attention kernels' bound over their
device time in the traced window, with each layer's own window.  Each
fused prefill whose first token came inside the window adds max(FLOPs /
bf16 peak, bytes / HBM peak) of its unpadded prompt, a window layer's
pairs cut to its window (``layer_counts.flash_prefill``), so padding to
the bucket shows as waste.  The time is the profiler's sum over the flash
kernels (the tensor-core and the CUDA-core one)."""
import numpy as np

from bench import layer_counts

KERNELS = r"flash_kernel|flash_attention_kernel"
PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense, data sheet (at a 700 W power limit)
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, data sheet


def read(m):
    if m.trace is None:
        return None
    sec = m.trace.seconds(KERNELS)
    if sec is None:
        return None
    run = m.run
    bound = 0.0
    for r in np.nonzero(run.inside(run.first))[0]:
        flops, nbytes = layer_counts.flash_prefill(m.model, int(run.prompt_lens[r]))
        bound += max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
    return 100.0 * bound / sec if bound else None
