"""The mean squared error of the rendered feature channels and the
rendered depth against the target, whose last channel is the depth."""

import torch

EXTRA_CHANNELS = 1   # the depth


def loss(image, depth, target):
  return torch.mean((torch.cat([image, depth[..., None]], -1) - target) ** 2)
