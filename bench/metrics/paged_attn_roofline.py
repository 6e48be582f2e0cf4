"""paged_attn_roofline (%): the paged-attention kernels' bound over their
device time in the traced window.  The bound is bytes over the HBM peak:
for each decode token inside the window, its row's K and V up to and
including the new token, its q read and its output written, in every
layer (``counts.paged_decode_bytes``), each byte once.  The time is the
profiler's sum over the split and combine kernels."""
from bench import counts

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
    return 100.0 * counts.paged_decode_bytes(m.model, lengths) / PEAK_BYTES_S / sec
