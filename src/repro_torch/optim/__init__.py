from .adamw import (adamw_init, adamw_update, adamw_update_zero, clip_by_global_norm,
                    global_norm)
from .schedule import warmup_cosine
