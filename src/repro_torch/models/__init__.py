"""repro_torch.models — the LM substrate's dense decoders (layer kinds
``attn`` and ``local``); the other families wait for ROADMAP item 12."""
from .convert import params_from_numpy
from .transformer import Model, init_params, stages_meta

__all__ = ["Model", "init_params", "stages_meta", "params_from_numpy"]
