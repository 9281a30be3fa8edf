"""repro_torch.models — the LM substrate's decoders (layer kinds ``attn``
and ``local``, dense or mixture-of-experts), xLSTM's ``mlstm``/``slstm``
blocks and hymba's ``hybrid`` layers; the encoder-decoder and vision
families wait for ROADMAP item 12."""
from .convert import opt_state_from_numpy, params_from_numpy
from .transformer import Model, init_params, stages_meta

__all__ = ["Model", "init_params", "stages_meta", "params_from_numpy",
           "opt_state_from_numpy"]
