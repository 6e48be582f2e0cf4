"""The 75th percentile over the judged positions of each position's logit
error: the root mean square over the vocabulary of the program's logits (as
the logits tap kept them, in bf16) less the reference's, over the standard
deviation of the reference's logits there.  Wrong state (a cache left
unchanged, rows of the batch left out) touches every position, or the rows
of half the sample; a router that flips on rounding touches a few
positions, which stay above the percentile."""
import numpy as np


def read(cmp):
    e = cmp["err"]
    return float(np.quantile(e, 0.75)) if e.size else None
