from repro_torch.optim.adamw import AdamW, AdamWState, clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.schedule import make_schedule  # noqa: F401
