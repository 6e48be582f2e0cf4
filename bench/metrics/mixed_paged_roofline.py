"""mixed_paged_roofline (%): the split-KV decode kernels' bound over their
device time in the traced window, with each layer's own window: for each
decode token inside the window, its row's K and V up to and including the
new token on a full layer, the last min(length, window) of them on a
window layer's ring, its q read and its output written
(``layer_counts.paged_decode_bytes``), each byte once, at the HBM peak.
The time is the profiler's sum over the split and combine kernels."""
from bench import layer_counts

KERNELS = r"paged_attention_(split|combine)"
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, data sheet (at a 700 W power limit)


def read(m):
    if m.trace is None:
        return None
    sec = m.trace.seconds(KERNELS)
    if sec is None:
        return None
    run = m.run
    dec = run.inside(run.t) & (run.idx > 0)
    lengths = (run.prompt_lens[run.rid[dec]] + run.idx[dec]).tolist()
    return 100.0 * layer_counts.paged_decode_bytes(m.model, lengths) / PEAK_BYTES_S / sec
