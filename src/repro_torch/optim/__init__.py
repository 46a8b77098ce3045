from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import cosine_lr
from repro_torch.optim.compression import (DoubleSqueezeState,
                                           double_squeeze_compress,
                                           double_squeeze_init, topk_sparsify)
