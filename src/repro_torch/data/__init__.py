from .pipeline import SyntheticTokens, make_batch_iterator
