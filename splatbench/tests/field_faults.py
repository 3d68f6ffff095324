"""Faults planted underneath the Feature 3DGS cell's run, beside those of
`faults.py`, as hooks of the same kind: one learning rate off by 10%, of
the semantic features' group or of the decoder's W and b."""


def semantic_lr_off():
  """The semantic features' group steps at 1.1 times its rate."""
  from taichi_gaussian_rasterizer_tpu_torch.optim import ParameterClass
  original = ParameterClass.create

  def broken(tensors, parameter_groups, *args, **kwargs):
    groups = {k: dict(v) for k, v in parameter_groups.items()}
    groups["semantic_feature"]["lr"] *= 1.1
    return original(tensors, groups, *args, **kwargs)

  ParameterClass.create = staticmethod(broken)


def decoder_lr_off():
  """The decoder's W and b step at 1.1 times their rate: `torch.optim.Adam`,
  which the cell steps them with and nothing else, made at 1.1 times the
  rate it is given (the reference's Adam is its own)."""
  import torch
  original = torch.optim.Adam

  class Broken(original):

    def __init__(self, params, lr=1e-3, **kwargs):
      super().__init__(params, lr=lr * 1.1, **kwargs)

  torch.optim.Adam = Broken
