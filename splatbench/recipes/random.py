"""Gaussians spread uniformly through the camera's frustum
(`scenes.random_3d_gaussians`): few overlaps a point, no tile saturates."""

from splatbench import scenes


def make(generator, points, camera):
  return scenes.random_3d_gaussians(generator, points, camera)
