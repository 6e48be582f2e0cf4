"""serve_mfu (%): the FLOPs that the window's tokens need, over the window
at the chip's bf16 peak.  Counted from the harness's own records
(``bench/counts.py``): each prompt whose first token came inside the
window, its prefill unpadded; each decode token inside the window, at its
position.  Padding, parked slots and recomputation are not counted."""
import numpy as np

from bench import counts

PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense, data sheet (at a 700 W power limit)


def read(m):
    run, model = m.run, m.model
    firsts = np.nonzero(run.inside(run.first))[0]
    flops = sum(counts.prefill_flops(model, int(run.prompt_lens[r])) for r in firsts)
    dec = run.inside(run.t) & (run.idx > 0)
    keys = run.prompt_lens[run.rid[dec]] + run.idx[dec]      # position + 1
    if model.get("window") is not None:
        keys = np.minimum(keys, model["window"])
    n = int(dec.sum())
    flops += n * 2 * (counts.layer_params(model) + counts.head_params(model))
    flops += counts.attn_flops_per_pair(model) * int(keys.sum())
    if not flops:
        return None
    return 100.0 * flops / (run.window_s * PEAK_FLOPS)
