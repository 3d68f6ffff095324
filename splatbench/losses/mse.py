"""The mean squared error of the rendered image against the target (the
loss of the port's `dp_train_step`)."""

import torch

EXTRA_CHANNELS = 0   # target channels beyond the image's


def loss(image, depth, target):
  return torch.mean((image - target) ** 2)
