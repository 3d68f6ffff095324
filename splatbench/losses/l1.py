"""The mean absolute error of the rendered image against the target."""

import torch

EXTRA_CHANNELS = 0   # target channels beyond the image's


def loss(image, depth, target):
  return torch.mean(torch.abs(image - target))
